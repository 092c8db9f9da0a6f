"""String predicates over fixed-width byte tensors: the plain versions.

Counterpart of ``presto_tpu/ops/strings.py``. A LIKE pattern is split
into ordered literal segments; each segment match is a sliding-window
byte comparison over the ``[rows, width]`` uint8 tensor. These are the
plain PyTorch versions: ``ops/cuda_strings.py`` runs the CUDA kernels on
the card and these on CPU tensors, and ``chip_smoke.py`` holds the
kernels against them.

Byte layout contract: rows are zero-padded on the right; the padding byte
0 never appears in content. The results cover every row (dead rows are
not masked); callers combine validity and liveness.
"""

from __future__ import annotations

import numpy as np
import torch


def encode_needle(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("latin1"), dtype=np.uint8)


def pad_literal(s: str, width: int) -> np.ndarray:
    out = np.zeros(width, dtype=np.uint8)
    b = s.encode("latin1")[:width]
    out[: len(b)] = np.frombuffer(b, dtype=np.uint8)
    return out


def _bytes_tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint8)).to(like.device)


def row_lengths(data: torch.Tensor) -> torch.Tensor:
    """Logical length of each row: the count of its NONZERO bytes (not
    the index of the first zero), int32."""
    return (data != 0).sum(dim=1, dtype=torch.int32)


def hits_matrix(data: torch.Tensor, needle: np.ndarray) -> torch.Tensor:
    """[n, nshift] bool: ``needle`` matches at shift s of each row."""
    width = data.shape[1]
    L = len(needle)
    nd = _bytes_tensor(needle, data)
    return torch.stack([(data[:, s: s + L] == nd).all(dim=1)
                        for s in range(width - L + 1)], dim=1)


def find_from(data: torch.Tensor, needle: np.ndarray, min_pos: torch.Tensor):
    """Earliest occurrence index of ``needle`` at a position >= min_pos
    per row; returns (found_pos int32, ok bool)."""
    n, width = data.shape
    L = len(needle)
    if L > width:
        return (torch.zeros(n, dtype=torch.int32, device=data.device),
                torch.zeros(n, dtype=torch.bool, device=data.device))
    nshift = width - L + 1
    shifts = torch.arange(nshift, device=data.device)
    valid = hits_matrix(data, needle) & (shifts[None, :] >= min_pos[:, None])
    ok = valid.any(dim=1)
    # the first True; argmax of an all-False row is 0, as in jnp
    found = valid.to(torch.int8).argmax(dim=1).to(torch.int32)
    return found, ok


def ends_at_length(data: torch.Tensor, needle: np.ndarray, min_pos: torch.Tensor):
    """True when ``needle`` occurs exactly at the end of the logical row
    (position == row_length - len) at a position >= min_pos."""
    n, width = data.shape
    L = len(needle)
    if L > width:
        return torch.zeros(n, dtype=torch.bool, device=data.device)
    nshift = width - L + 1
    lens = row_lengths(data)
    s_idx = torch.arange(nshift, device=data.device)
    valid = (hits_matrix(data, needle)
             & (s_idx[None, :] >= min_pos[:, None])
             & (s_idx[None, :] + L == lens[:, None]))
    return valid.any(dim=1)


def like_mask(data: torch.Tensor, pattern: str) -> torch.Tensor:
    """SQL LIKE on byte rows with '%' wildcards ('_' raises).

    Greedy earliest-occurrence matching for interior segments; the final
    segment of an end-anchored pattern is matched as a SUFFIX at the
    logical row length ('%1' matches '...011' although a '1' occurs
    earlier)."""
    if "_" in pattern:
        raise NotImplementedError("LIKE '_' wildcard on byte columns")
    n, width = data.shape
    dev = data.device
    segs = pattern.split("%")
    anchored_start = segs[0] != ""
    anchored_end = segs[-1] != ""
    segs_nonempty = [s for s in segs if s != ""]
    if not segs_nonempty:
        if pattern == "":  # LIKE '' matches only empty strings
            return row_lengths(data) == 0
        return torch.ones(n, dtype=torch.bool, device=dev)  # all wildcards
    if len(segs) == 1:  # no '%': exact equality (padding included)
        if len(pattern) > width:
            return torch.zeros(n, dtype=torch.bool, device=dev)
        return bytes_eq_literal(data, pattern)
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    pos = torch.zeros(n, dtype=torch.int32, device=dev)
    inner = segs_nonempty[:-1] if anchored_end else segs_nonempty
    for i, seg in enumerate(inner):
        needle = encode_needle(seg)
        if i == 0 and anchored_start:
            L = len(needle)
            if L > width:
                return torch.zeros(n, dtype=torch.bool, device=dev)
            ok = ok & (data[:, :L] == _bytes_tensor(needle, data)).all(dim=1)
            pos = torch.full((n,), L, dtype=torch.int32, device=dev)
            continue
        found, hit = find_from(data, needle, pos)
        ok = ok & hit
        pos = found + len(seg)
    if anchored_end:
        ok = ok & ends_at_length(data, encode_needle(segs_nonempty[-1]), pos)
    return ok


def starts_with_mask(data: torch.Tensor, prefix: str) -> torch.Tensor:
    needle = encode_needle(prefix)
    L = len(needle)
    if L > data.shape[1]:
        return torch.zeros(data.shape[0], dtype=torch.bool, device=data.device)
    return (data[:, :L] == _bytes_tensor(needle, data)).all(dim=1)


def substr(data: torch.Tensor, start: int, length: int) -> torch.Tensor:
    """1-based SQL substr with static bounds -> BYTES(length) (narrower
    when the column ends first, as in the JAX package)."""
    return data[:, start - 1: start - 1 + length]


def bytes_eq_literal(data: torch.Tensor, s: str) -> torch.Tensor:
    lit = _bytes_tensor(pad_literal(s, data.shape[1]), data)
    return (data == lit).all(dim=1)


def bytes_compare(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic 3-way compare of two [n, W] byte tensors: int32 in
    {-1, 0, 1} per row."""
    diff = a != b
    any_diff = diff.any(dim=1)
    first = diff.to(torch.int8).argmax(dim=1)
    idx = torch.arange(a.shape[0], device=a.device)
    sign = torch.sign(a[idx, first].to(torch.int32) - b[idx, first].to(torch.int32))
    return torch.where(any_diff, sign, torch.zeros_like(sign)).to(torch.int32)
