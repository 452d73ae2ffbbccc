"""PyTorch + CUDA port of the SCL deepfake-audio detector for NVIDIA Hopper.

Imports torch only, never jax and nothing of
``scl_deepfake_audio_detection_tpu``.
"""
