"""Variable-length batching helpers.  Of
``scl_deepfake_audio_detection_tpu/data/generic_io.py`` the port keeps only
``pad_to_bucket``, which is all that ``train/scoring.bucketed_batches``
needs."""

from __future__ import annotations


def pad_to_bucket(length: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` >= length (>= multiple)."""
    return max(((length + multiple - 1) // multiple), 1) * multiple
