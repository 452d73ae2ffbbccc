"""PyTorch + CUDA port of the SCL deepfake-audio detector for NVIDIA Hopper.

Imports torch only, never jax and nothing of
``scl_deepfake_audio_detection_tpu``.
"""

from scl_deepfake_audio_detection_torch.version import __version__

__all__ = ["__version__"]
