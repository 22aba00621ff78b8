"""alvaar_tpu_torch — the PyTorch/CUDA port of alvaar_tpu's single-stream
SLAM path.  Imports torch and numpy only, never jax or alvaar_tpu."""

from alvaar_tpu_torch.config import SlamConfig
from alvaar_tpu_torch.system import AlvaAR, pose_to_array

__all__ = ["AlvaAR", "SlamConfig", "pose_to_array"]
