"""Model zoo.

The heads register their names (and the reference's ``wav2vec2_*``
aliases) in ``utils.registry.MODELS`` when a lookup first imports them
(``utils.registry._POPULATORS``; importing them here would close an import
cycle through ``ops.graph`` and ``ops.relpos_transformer``).  The package
loads the conformer, as the JAX package's ``models/__init__`` does; it
registers no name.
"""

from scl_deepfake_audio_detection_torch.models import conformer  # noqa: F401
