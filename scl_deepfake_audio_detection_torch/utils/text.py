"""Text/ARPAbet tokenization for TTS-style front-ends.

Counterpart of ``scl_deepfake_audio_detection_tpu/utils/text.py`` (numpy
only, the same code and the same symbol table in the same order).

Capability match for the vendored NII text-processing toolkit
(``core_scripts/data_io/text_process/text_io.py:34-141``,
``toolkit_all.py:26-62``, ``toolkit_en.py:22-220``): convert mixed
raw-text / phonemic-annotation strings into integer symbol sequences and
back.  Dead code in the reference's anti-spoofing pipeline (TTS leftovers
from project-NN-Pytorch-scripts) but part of its library surface, so users
migrating text-conditioned experiments find the same capability here.

Design differences from the reference, deliberate:
- the symbol inventory and its index order are IDENTICAL (pad, eos,
  letters, punctuation, 87 stress-marked ARPAbet symbols), so sequences
  tokenized by the reference decode identically here and vice versa;
- codes are returned as int32 numpy arrays ready for embedding lookups
  (the reference stores them as float32 — ``text_io.py:64`` with
  ``conf.py:24`` — which every consumer must cast back; we do not copy
  that quirk, ``np.asarray(codes, np.float32)`` restores it if needed);
- no module-level g2p_en import side effects: an optional ``g2p`` callable
  is injected instead (zero-egress images have no g2p_en).

Reference-faithful QUIRKS deliberately kept (pinned symbol-for-symbol by
the JAX package's tests against the reference toolkit):
- ARPA annotation splits on ``_`` only (``{AH_IH}``); a space-separated
  ``{AH IH}`` silently encodes to nothing (``arpabet2indices`` splits on
  ``_pad`` and an unknown ``@``-token is dropped);
- inside ``{}`` every non-space token gets the ``@`` marker, so punctuation
  there (and in g2p output, which is routed through ``{}``) is dropped;
- number spelling restores a LEADING space but eats a trailing one, so the
  space before a ``{}`` chunk does not survive into the code sequence.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Symbol inventory (toolkit_en.py:22-56) — order defines the integer codes
# ---------------------------------------------------------------------------

PAD = "_"
EOS = "~"
_PUNCTUATION = "!'(),-.:;? "
_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
#: CMUdict ARPAbet phones, vowels crossed with lexical stress 0/1/2
#: (toolkit_en.py:36-47)
ARPABET = [
    "AA", "AA0", "AA1", "AA2", "AE", "AE0", "AE1", "AE2",
    "AH", "AH0", "AH1", "AH2", "AO", "AO0", "AO1", "AO2",
    "AW", "AW0", "AW1", "AW2", "AY", "AY0", "AY1", "AY2",
    "B", "CH", "D", "DH", "EH", "EH0", "EH1", "EH2",
    "ER", "ER0", "ER1", "ER2", "EY", "EY0", "EY1", "EY2",
    "F", "G", "HH", "IH", "IH0", "IH1", "IH2", "IY", "IY0",
    "IY1", "IY2", "JH", "K", "L", "M", "N", "NG", "OW", "OW0",
    "OW1", "OW2", "OY", "OY0", "OY1", "OY2", "P", "R", "S",
    "SH", "T", "TH", "UH", "UH0", "UH1", "UH2", "UW", "UW0",
    "UW1", "UW2", "V", "W", "Y", "Z", "ZH",
]
_ARPA_MARKER = "@"

#: Full symbol table; index == integer code (toolkit_en.py:51-57).
SYMBOLS: List[str] = (
    [PAD] + [EOS] + list(_LETTERS) + list(_PUNCTUATION)
    + [_ARPA_MARKER + p for p in ARPABET]
)
_SYMBOL_TO_INDEX = {s: i for i, s in enumerate(SYMBOLS)}
#: pad/eos are never produced by tokenization itself (toolkit_en.py:31)
_SKIP = {PAD, EOS}


def symbol_count() -> int:
    """Vocabulary size (embedding-table rows) — ``toolkit_en.symbol_num``."""
    return len(SYMBOLS)


def eos_index() -> int:
    """Integer code of the end-of-sentence symbol."""
    return _SYMBOL_TO_INDEX[EOS]


# ---------------------------------------------------------------------------
# Curly-bracket phonemic annotation (toolkit_all.py:26-62)
# ---------------------------------------------------------------------------

_CURLY_RE = re.compile(r"(.*?)\{(.+?)\}(.*)")


def parse_curly_bracket(text: str) -> List[str]:
    """Split mixed text into raw-text and ``{ARPA}`` chunks.

    A chunk starting with ``{`` is phonemic annotation (the closing brace
    is dropped, the opening one kept as the marker):
    ``'text {AH IH} test' -> ['text ', '{AH IH', ' test']``.
    Empty chunks are filtered (``toolkit_all.py:60-62``)."""
    chunks: List[str] = []
    rest = text
    while rest:
        m = _CURLY_RE.match(rest)
        if not m:
            chunks.append(rest)
            break
        chunks.append(m.group(1))
        chunks.append("{" + m.group(2))
        rest = m.group(3)
    return [c for c in chunks if c]


# ---------------------------------------------------------------------------
# English normalization (toolkit_en.py:77-110 — placeholder-grade by design)
# ---------------------------------------------------------------------------

_WHITESPACE_RE = re.compile(r"\s+")
_DIGIT_NAMES = {
    "0": "zero", "1": "one", "2": "two", "3": "three", "4": "four",
    "5": "five", "6": "six", "7": "seven", "8": "eight", "9": "nine",
}


def spell_out_numbers(text: str) -> str:
    """Replace all-digit words by their spelled-out digits
    (``'abc 123' -> 'abc one two three'``; mixed tokens left alone)."""
    def _word(w: str) -> str:
        if w and all(ch in _DIGIT_NAMES for ch in w):
            return " ".join(_DIGIT_NAMES[ch] for ch in w)
        return w

    out = " ".join(_word(w) for w in text.split())
    return " " + out if text.startswith(" ") else out


def normalize_text(text: str) -> str:
    """Lowercase, spell out digit-only words, collapse whitespace."""
    return _WHITESPACE_RE.sub(" ", spell_out_numbers(text.lower()))


def clean_g2p_symbols(symbols: Sequence[str]) -> List[str]:
    """Drop the spaces a g2p tool emits at the start and around punctuation
    (``toolkit_en.g2poutput_process:113-137``)."""
    punct = set(_PUNCTUATION)
    out: List[str] = []
    for i, sym in enumerate(symbols):
        if sym == " ":
            if i == 0:
                continue
            if i < len(symbols) - 1 and symbols[i + 1] in punct:
                continue
            if symbols[i - 1] in punct:
                continue
        out.append(sym)
    return out


# ---------------------------------------------------------------------------
# Encoding / decoding
# ---------------------------------------------------------------------------

def _encode_raw(text: str) -> List[int]:
    """Indices of normalized raw text (unknown chars silently dropped —
    ``toolkit_en.rawtext2indices:158-170``)."""
    norm = normalize_text(text)
    return [
        _SYMBOL_TO_INDEX[ch]
        for ch in norm
        if ch in _SYMBOL_TO_INDEX and ch not in _SKIP
    ]


def _encode_arpabet(arpa_text: str) -> List[int]:
    """Indices of a ``_``-separated ARPAbet chunk (``'AH_HH'``);
    spaces pass through as the space symbol
    (``toolkit_en.arpabet2indices:172-188``)."""
    out: List[int] = []
    for tok in arpa_text.split(PAD):
        sym = tok if tok == " " else _ARPA_MARKER + tok
        if sym in _SYMBOL_TO_INDEX and sym not in _SKIP:
            out.append(_SYMBOL_TO_INDEX[sym])
    return out


def text_to_codes(text: str, lang: str = "EN") -> np.ndarray:
    """Tokenize mixed text/``{ARPA}`` into int32 codes, EOS appended after
    the final chunk (``text_io.text2code:34-66``)."""
    if lang != "EN":
        raise ValueError(f"unsupported language: {lang!r}")
    chunks = parse_curly_bracket(text)
    codes: List[int] = []
    for i, chunk in enumerate(chunks):
        if chunk.startswith("{"):
            codes += _encode_arpabet(chunk.lstrip("{"))
        else:
            codes += _encode_raw(chunk)
        if i == len(chunks) - 1:
            codes.append(eos_index())
    # empty input -> empty sequence (no chunk means no EOS), as the reference
    return np.asarray(codes, dtype=np.int32)


def codes_to_text(codes: Sequence[int]) -> str:
    """Decode integer codes back to text; ARPAbet symbols come back as
    space-separated phone names (``toolkit_en.code2text:215-220`` — the
    reference documents the same non-invertibility)."""
    txt = "".join(SYMBOLS[int(c)] for c in codes)
    return _WHITESPACE_RE.sub(" ", txt.replace(_ARPA_MARKER, " "))


def g2p_to_codes(
    text: str, g2p: Callable[[str], Sequence[str]], lang: str = "EN"
) -> np.ndarray:
    """Run an injected grapheme-to-phoneme callable (g2p_en-compatible:
    string -> list of ARPAbet/punctuation symbols) and tokenize its output
    (``text_io.g2p2code:144-182``).  Refuses input that already carries
    ``{}`` annotation, like the reference."""
    chunks = parse_curly_bracket(text)
    if len(chunks) > 1 or (chunks and chunks[0].startswith("{")):
        raise ValueError("g2p input must not contain {} phonemic annotation")
    symbols = clean_g2p_symbols(list(g2p(text)))
    return text_to_codes("{" + PAD.join(symbols) + "}", lang)


def load_text_file(
    path: str,
    lang: str = "EN",
    g2p: Optional[Callable[[str], Sequence[str]]] = None,
) -> np.ndarray:
    """Read a text file (lines joined by spaces, CR/LF chopped) and
    tokenize it (``text_io.textloader:123-141``)."""
    with open(path) as f:
        text = " ".join(line.rstrip("\r\n") for line in f)
    if g2p is not None:
        return g2p_to_codes(text, g2p, lang)
    return text_to_codes(text, lang)
