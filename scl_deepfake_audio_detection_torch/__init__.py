"""PyTorch + CUDA port of the SCL deepfake-audio detector for NVIDIA Hopper.

Imports torch only, never jax and nothing of
``scl_deepfake_audio_detection_tpu``.
"""

__version__ = "0.1.0"  # the JAX package's, whose artifacts and checkpoints it reads
