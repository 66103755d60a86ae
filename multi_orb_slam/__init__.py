"""Multi-camera SLAM engine in JAX, run on an NVIDIA GPU.

A from-scratch JAX/XLA re-design of the capabilities of
AlterPang/Multi_ORB_SLAM (a dual RGB-D camera fork of ORB-SLAM2):

- ORB pyramid feature extraction batched over pyramid levels
- Descriptor matching as masked batched Hamming argmin kernels
- Bag-of-words place recognition as vectorized tree descent + inverted index
- The full optimization stack (motion-only BA, local BA with explicit Schur
  complement, Sim3 loop refinement, essential-graph pose optimization, global
  BA) as batched Levenberg-Marquardt solvers with per-observation rig
  extrinsics
- Distributed bundle adjustment over a `jax.sharding.Mesh` (map-point blocks
  sharded over devices, Schur camera system reduced with `psum`)

The reference's pointer-graph + 3-thread design is replaced by fixed-capacity
structure-of-arrays state and a deterministic staged pipeline
(track -> map-update -> loop-check).  See SURVEY.md for the reference
structural analysis this is built against.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# SLAM geometry is numerically unforgiving: pose chains (Tcw compositions),
# normal-equation assembly, and Schur solves all run through dot_general,
# and an accelerator's DEFAULT matmul precision truncates f32 operands
# (TF32 on a GPU keeps a 10-bit mantissa, ~1e-3 relative error).  With
# reduced-precision products in the BA accumulations the tracker loses the
# map and emits NaN poses, so float32 is the default for the whole
# process.  Hot ops that tolerate reduced precision (image convolutions,
# matmuls over +-1 or 0/1 operands, whose products are exact) opt back in
# locally with an explicit precision argument.
#
# NOTE: this mutates PROCESS-GLOBAL JAX config at import, which changes the
# numerics/perf defaults of unrelated JAX code sharing the process.  Set
# MULTI_ORB_SLAM_NO_PRECISION_OVERRIDE=1 to opt out — but then every SLAM
# entry point must run under
# `with jax.default_matmul_precision("float32"): ...` (see above).
if not _os.environ.get("MULTI_ORB_SLAM_NO_PRECISION_OVERRIDE"):
    _jax.config.update("jax_default_matmul_precision", "float32")
