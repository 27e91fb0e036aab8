"""2-bit DNA codec — the port of ``repro.core.codec``.

Alphabetical codes A,C,G,T -> 0,1,2,3, packed big-endian into 32-bit
words (base ``s`` of a word at bit ``30 - 2s``), so an unsigned word
compare is a 16-base lexicographic compare.

Packed words are ``torch.uint32`` tensors.  PyTorch on the CPU cannot
compare or shift ``uint32``, so arithmetic widens them with
:func:`words_i64` to ``int64`` holding the unsigned value and narrows the
result back with :func:`words_u32`.  In ``int64`` a left shift does not
wrap at 32 bits, so every left shift below is masked with ``MASK32``.
The host-side batch helpers stay numpy, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

DNA_ALPHABET = "ACGT"
BASES_PER_WORD = 16  # 2 bits/base, 32-bit words
MASK32 = 0xFFFFFFFF
_ASCII_TO_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(DNA_ALPHABET):
    _ASCII_TO_CODE[ord(_c)] = _i
    _ASCII_TO_CODE[ord(_c.lower())] = _i


def encode_dna(text: str | bytes | np.ndarray) -> np.ndarray:
    """ASCII DNA -> uint8 codes in {0,1,2,3}.  Raises on non-ACGT symbols."""
    if isinstance(text, str):
        text = text.encode("ascii")
    if isinstance(text, (bytes, bytearray)):
        text = np.frombuffer(bytes(text), dtype=np.uint8)
    codes = _ASCII_TO_CODE[text]
    if np.any(codes == 255):
        bad = chr(int(text[np.argmax(codes == 255)]))
        raise ValueError(f"non-DNA symbol {bad!r} in input")
    return codes


def decode_dna(codes) -> str:
    if isinstance(codes, torch.Tensor):
        codes = codes.cpu().numpy()
    return "".join(DNA_ALPHABET[int(c)] for c in np.asarray(codes))


def random_dna(n: int, seed: int = 0) -> np.ndarray:
    """Synthetic chromosome stand-in (uniform ACGT), uint8 codes — the
    same numpy generator as the reference, so a seed gives the same text."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=n, dtype=np.uint8)


# Word helpers ---------------------------------------------------------------
def words_i64(words: torch.Tensor) -> torch.Tensor:
    """uint32 words -> int64 holding the unsigned value."""
    return words.view(torch.int32).to(torch.int64) & MASK32


def words_u32(values: torch.Tensor) -> torch.Tensor:
    """int64 values (only the low 32 bits are kept) -> uint32 words."""
    v = values & MASK32
    v = torch.where(v >= 2**31, v - 2**32, v)
    return v.to(torch.int32).view(torch.uint32)


def as_tensor(x, device=None) -> torch.Tensor:
    """numpy array / tensor -> tensor (on ``device`` when given).  uint32
    numpy arrays keep their dtype."""
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.ascontiguousarray(x)
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
    return t if device is None else t.to(device)


_SHIFTS = [30 - 2 * s for s in range(BASES_PER_WORD)]


# Packing -------------------------------------------------------------------
def packed_length(n_bases: int) -> int:
    return (n_bases + BASES_PER_WORD - 1) // BASES_PER_WORD


def pack_2bit(codes) -> torch.Tensor:
    """codes {0..3} (numpy or tensor, any integer dtype) -> (n_words,)
    uint32 words, big-endian; trailing slots are zero ('A').  Plain
    PyTorch on the codes' device (numpy input lands on the CPU)."""
    c = as_tensor(codes).to(torch.int64)
    n = int(c.shape[0])
    n_words = packed_length(n)
    c = torch.nn.functional.pad(c, (0, n_words * BASES_PER_WORD - n))
    lanes = c.reshape(n_words, BASES_PER_WORD)
    shifts = torch.tensor(_SHIFTS, dtype=torch.int64, device=c.device)
    # the 16 fields are disjoint, so the sum is the OR
    return words_u32((lanes << shifts[None, :]).sum(dim=1))


def unpack_2bit(words: torch.Tensor, n_bases: int) -> torch.Tensor:
    """Inverse of :func:`pack_2bit`: (n_words,) uint32 -> (n_bases,) uint8."""
    w = words_i64(as_tensor(words))
    shifts = torch.tensor(_SHIFTS, dtype=torch.int64, device=w.device)
    lanes = (w[:, None] >> shifts[None, :]) & 3
    return lanes.reshape(-1)[:n_bases].to(torch.uint8)


def pack_2bit_batch(codes: np.ndarray) -> np.ndarray:
    """Batched host-side pack: (B, L) codes {0..3} -> (B, W) uint32 words,
    same bit layout as :func:`pack_2bit`.  Pure numpy."""
    codes = np.asarray(codes)
    B, L = codes.shape
    n_words = packed_length(L)
    pad = n_words * BASES_PER_WORD - L
    if pad:
        codes = np.pad(codes, ((0, 0), (0, pad)))
    lanes = codes.astype(np.uint32).reshape(B, n_words, BASES_PER_WORD)
    shifts = np.asarray(_SHIFTS, np.uint32)
    return np.bitwise_or.reduce(
        (lanes << shifts[None, None, :]).astype(np.uint32), axis=2)


def unpack_2bit_batch(words: np.ndarray, n_bases: int) -> np.ndarray:
    """Batched host-side unpack: (B, W) uint32 -> (B, n_bases) uint8, the
    exact inverse of :func:`pack_2bit_batch`.  Pure numpy."""
    words = np.asarray(words, dtype=np.uint32)
    B, W = words.shape
    if n_bases > W * BASES_PER_WORD:
        raise ValueError(f"n_bases={n_bases} exceeds the {W} words' "
                         f"{W * BASES_PER_WORD} slots")
    shifts = np.asarray(_SHIFTS, np.uint32)
    lanes = (words[:, :, None] >> shifts[None, None, :]) & np.uint32(3)
    return lanes.reshape(B, W * BASES_PER_WORD)[:, :n_bases].astype(np.uint8)


def extract_window(packed: torch.Tensor, pos: torch.Tensor,
                   n_words: int) -> torch.Tensor:
    """``n_words`` packed words of the suffix starting at base ``pos``
    (any alignment), vectorized over a batch of positions: returns
    (*pos.shape, n_words) uint32.  Words past the end of ``packed`` read
    as 0 ('A'); callers depth-cap compares at the text end themselves."""
    batch_shape = tuple(pos.shape)
    pos = pos.reshape(-1).to(torch.int64)
    n_pk = int(packed.shape[0])
    word_idx = pos // BASES_PER_WORD
    sh = (2 * (pos % BASES_PER_WORD))[:, None]
    offs = torch.arange(n_words + 1, dtype=torch.int64, device=pos.device)
    idx = word_idx[:, None] + offs[None, :]
    in_range = idx < n_pk
    src = words_i64(packed)
    if n_pk:
        w = torch.where(in_range, src[idx.clamp(0, n_pk - 1)], 0)
    else:
        w = torch.zeros(idx.shape, dtype=torch.int64, device=pos.device)
    hi = w[:, :-1]
    lo = w[:, 1:]
    # a shift by 32 is undefined in C and wrong here: guard sh == 0
    out = torch.where(sh == 0, hi,
                      ((hi << sh) & MASK32) | (lo >> (32 - sh)))
    return words_u32(out).reshape(*batch_shape, n_words)
