"""The JAX package's native libraries, loaded whole, for the port's tests.

The JAX package builds ``native/libscl_host.so`` and ``libscl_codec.so``
with ``g++ -o`` in place, with no temporary file and no rename, and a
process that fails to load its library once (``_tried``,
``_codec_tried``) reports "no library" for the rest of its life.  Under
``pytest -n 6`` several workers of a fresh checkout build and load those
files at once, so a worker can load a half-written file and from then on
skip, or quietly stop testing, everything that needs the library.

``host()`` and ``codec()`` take a lock under the port's build directory
(one port test worker retries at a time), and retry the JAX package's load
after resetting its ``_tried`` flag until the library loads or a deadline
passes.  The port's loader is race-safe (it builds to a temporary file and
renames it), so it decides what the machine can build: where the port's
library loads and the JAX package's still does not at the deadline, the
test fails; where the port's does not load either (no compiler, no libav*),
``False`` lets the test skip or take its other path.
"""

import fcntl
import time

import pytest

import scl_deepfake_audio_detection_tpu.native as jnative
from scl_deepfake_audio_detection_torch import native as pnative

DEADLINE_S = 180.0
RETRY_S = 0.5


def _ready(name: str, port_ok, jax_ok, flag: str) -> bool:
    if not port_ok():
        return False
    pnative.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    deadline = time.monotonic() + DEADLINE_S
    with open(pnative.BUILD_DIR / "jax_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            while not jax_ok():
                if time.monotonic() > deadline:
                    pytest.fail(f"the port's {name} library loads, the JAX package's "
                                f"did not within {DEADLINE_S:.0f} s")
                setattr(jnative, flag, False)  # let its loader try again
                time.sleep(RETRY_S)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return True


def host() -> bool:
    """Whether both packages' host libraries load (False: the port's does
    not build here)."""
    return _ready("host", pnative.available, jnative.available, "_tried")


def codec() -> bool:
    """Whether both packages' codec libraries load (False: libav* or its
    headers are absent, so the port's does not build either)."""
    return _ready("codec", pnative.codec_available, jnative.codec_available, "_codec_tried")
