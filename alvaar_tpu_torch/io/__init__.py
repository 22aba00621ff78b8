from alvaar_tpu_torch.io.frame_ring import FrameRing

__all__ = ["FrameRing"]
