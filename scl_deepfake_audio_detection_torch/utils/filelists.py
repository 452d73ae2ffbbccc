"""File-list manipulation, deterministic name anonymization, block shuffles.

Counterpart of ``scl_deepfake_audio_detection_tpu/utils/filelists.py``
(numpy only, the same code).

Capability match for the vendored NII utility belt that the component
inventory lists but no dataset module imports:

- ``core_scripts/other_tools/list_tools.py:21-176`` — directory listings by
  extension, list set-algebra, text-file list IO;
- ``core_scripts/other_tools/str_tools.py:17-51`` — path assembly and
  CR/LF chopping;
- ``core_scripts/other_tools/random_name_mgn.py:34-104`` — the random-name
  manager used to anonymize utterance ids when producing listening-test /
  challenge protocols;
- ``core_scripts/math_tools/random_tools.py:25-133`` — Fisher-Yates block
  shuffles (within blocks / of blocks), the primitive under the
  sort-by-length sampler.

Design differences, deliberate: every random operation takes an explicit
``numpy.random.Generator`` (the reference uses the global ``random`` module —
unseedable per call site); shuffles return new lists instead of mutating
(callers here hold immutable index tuples); the name manager keeps the
reference's pop-from-the-end draw order so protocols generated from the same
name pool file line up.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Iterable, List, Optional, Sequence, Tuple, TypeVar

import numpy as np

T = TypeVar("T")


# ---------------------------------------------------------------------------
# Directory listings / list set-algebra (list_tools.py)
# ---------------------------------------------------------------------------

def listdir_stems(
    file_dir: str, ext: Optional[str] = None, recursive: bool = False
) -> List[str]:
    """File-name stems (extension stripped) under ``file_dir``; dotfiles
    skipped; recursive walk keeps subdirectory prefixes and follows
    symlinks (``list_tools.listdir_with_ext*:21-88``).  Missing directory
    -> empty list, matching the reference's warn-and-continue.  Results are
    sorted and directories are excluded in flat mode (the reference returns
    os.listdir order and lets directory names through when ``ext`` is
    None — both warts, not capabilities)."""
    if not recursive:
        try:
            names = os.listdir(file_dir)
        except OSError:
            return []
        return sorted(
            os.path.splitext(n)[0]
            for n in names
            if not n.startswith(".")
            and (ext is None or n.endswith(ext))
            and os.path.isfile(os.path.join(file_dir, n))
        )
    stems: List[str] = []
    root_prefix = file_dir.rstrip(os.sep) + os.sep
    for root, dirs, files in os.walk(root_prefix, followlinks=True):
        dirs[:] = [d for d in dirs if not d.startswith(".")]  # prune dot-dirs
        rel = root[len(root_prefix):] if root.startswith(root_prefix) else root
        stems += [
            os.path.splitext(os.path.join(rel, n))[0]
            for n in files
            if not n.startswith(".") and (ext is None or n.endswith(ext))
        ]
    return sorted(stems)


def common_members(a: Iterable[T], b: Iterable[T]) -> List[T]:
    """Sorted intersection (``list_tools.common_members:90-103``)."""
    return sorted(set(a) & set(b))


def is_permutation(a: Sequence[T], b: Sequence[T]) -> bool:
    """Same members with the same multiplicities
    (``list_tools.list_identical:106-111``)."""
    return Counter(a) == Counter(b)


def is_subset(a: Iterable[T], b: Iterable[T]) -> bool:
    """Whether every member of ``b`` appears in ``a``
    (``list_tools.list_b_in_list_a:113-124``)."""
    return set(b) <= set(a)


def members_not_in(a: Iterable[T], b: Iterable[T]) -> List[T]:
    """Members of ``a`` absent from ``b``, sorted (the reference's
    ``members_in_a_not_in_b:126-136`` returns arbitrary set order — sorted
    here for determinism)."""
    return sorted(set(a) - set(b))


def read_lines(path: str, chop: bool = True) -> List[str]:
    """Text file -> list of lines, CR/LF chopped by default
    (``list_tools.read_list_from_text:138-153``)."""
    with open(path) as f:
        return [line.rstrip("\r\n") if chop else line for line in f]


def write_lines(items: Iterable[object], path: str, end: str = "\n") -> None:
    """List -> text file, one ``str()``-converted element per line
    (``list_tools.write_list_to_text_file:155-171``)."""
    with open(path, "w") as f:
        for item in items:
            f.write(f"{item}{end}")


def resolve_path(file_dir: str, name: str, ext: str) -> str:
    """``dir/name.ext`` with or without the leading dot on ``ext``
    (``str_tools.f_realpath:17-31``)."""
    sep = "" if ext.startswith(os.extsep) else os.extsep
    return os.path.join(file_dir, name) + sep + ext


# ---------------------------------------------------------------------------
# Block shuffles (random_tools.py)
# ---------------------------------------------------------------------------

def shuffle_within_blocks(
    items: Sequence[T], block_size: int, rng: np.random.Generator
) -> List[T]:
    """Shuffle independently inside each consecutive ``block_size`` chunk;
    chunk boundaries stay put (``random_tools.f_shuffle_in_block_inplace``).

    With length-sorted input this randomizes batch composition while keeping
    similar lengths adjacent — the padding-waste control behind
    ``data.sampler.block_shuffle_by_length``."""
    out = list(items)
    if block_size <= 1:
        return out
    for start in range(0, len(out), block_size):
        stop = min(start + block_size, len(out))
        perm = rng.permutation(stop - start)
        out[start:stop] = [out[start + int(p)] for p in perm]
    return out


def shuffle_blocks(
    items: Sequence[T], block_size: int, rng: np.random.Generator
) -> List[T]:
    """Shuffle whole ``block_size`` blocks as units; a trailing partial
    block stays at the end untouched, as in the reference
    (``random_tools.f_shuffle_blocks_inplace:99-133``)."""
    out = list(items)
    n_blocks = len(out) // block_size
    if n_blocks > 1:
        order = rng.permutation(n_blocks)
        head = [
            out[int(b) * block_size + i]
            for b in order
            for i in range(block_size)
        ]
        out[: n_blocks * block_size] = head
    return out


# ---------------------------------------------------------------------------
# Random-name anonymizer (random_name_mgn.py)
# ---------------------------------------------------------------------------

class RandomNameMap:
    """Assign each real file name a pseudonym drawn from a fixed pool.

    The reference uses this to anonymize utterance ids when publishing
    listening-test protocols (``random_name_mgn.RandomNameMgn:34-104``).
    Names are drawn by popping from the END of the pool list, matching the
    reference, so the same pool file yields the same assignment sequence.
    The mapping is bijective and repeat-stable: asking again for a known
    file returns its existing pseudonym.
    """

    def __init__(self, pool: Sequence[str]):
        self._unused: List[str] = list(pool)
        self._by_alias = {}  # alias -> real name
        self._by_name = {}   # real name -> alias

    @classmethod
    def from_file(cls, path: str) -> "RandomNameMap":
        return cls(read_lines(path))

    def alias_for(self, filename: str) -> str:
        """Pseudonym for ``filename``, drawing a fresh one on first sight
        (``retrieve_rand_name:70-82``).  Raises when the pool runs dry
        (the reference IndexErrors from ``list.pop``)."""
        if filename in self._by_name:
            return self._by_name[filename]
        if not self._unused:
            raise RuntimeError("random-name pool exhausted")
        alias = self._unused.pop()
        self._by_alias[alias] = filename
        self._by_name[filename] = alias
        return alias

    def filename_for(self, alias: str) -> str:
        """Reverse lookup (``retrieve_filename:99-104``); unknown alias is
        an error here, not a sys.exit."""
        try:
            return self._by_alias[alias]
        except KeyError:
            raise KeyError(f"random name never assigned: {alias!r}") from None

    @property
    def num_unused(self) -> int:
        return len(self._unused)

    def save_unused(self, path: str) -> None:
        """Persist names not yet assigned, for continuing the same protocol
        later (``save_unused_name:84-97``)."""
        write_lines(self._unused, path)

    def items(self) -> List[Tuple[str, str]]:
        """(real name, alias) pairs in assignment order."""
        return [(n, a) for a, n in self._by_alias.items()]
