"""sgtd_tpu — semantic-guided triangle-descriptor LiDAR global-localization
and SLAM engine in JAX.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of the SGTD
reference stack (Hfx-J/SGTD): semantic cluster extraction (DCVC), triangle
descriptor construction with geometric-hash keys, batched vote search +
SVD/RANSAC verification, GICP refinement, pose-graph optimization, and
multi-device sharded matching. See SURVEY.md at the repo root for the
reference analysis this implements.
"""

from sgtd_tpu.config import SGTDConfig, DEFAULT_CONFIG  # noqa: F401

__version__ = "0.1.0"
