"""Plain PyTorch version of the permdraw kernel, on any device.

The same steps as ``csrc/permdraw.cu``: row t's words from Philox4x32-10
under the key at the counter (w // 4, t mod 2^32, t // 2^32, 0), and a
Fisher–Yates shuffle whose j in [0, i] comes from Lemire's multiply-shift
with rejection. It loops over the shuffle's positions and vectorises over
the rows, in exact int64 arithmetic (a 32 × 32-bit product is split so
that no partial product passes 2^49), so it gives the kernel's rows bit for
bit.
"""

from __future__ import annotations

import torch

__all__ = ["permdraw_ref", "philox4x32_10"]

M0, M1 = 0xD2511F53, 0xCD9E8D57          # Philox multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85          # Weyl key increments
MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, c: torch.Tensor) -> tuple:
    """(high, low) 32 bits of the 64-bit product m·c, for a 32-bit constant
    m and int64 c holding 32-bit values: c in 16-bit halves, so each partial
    product stays below 2^48 and nothing overflows int64."""
    a = m * (c >> 16)
    s = ((a & 0xFFFF) << 16) + m * (c & 0xFFFF)
    return (a >> 16) + (s >> 32), s & MASK32


def philox4x32_10(key: tuple, c0, c1, c2, c3) -> tuple:
    """Philox4x32-10 of the counter words (int64 tensors holding 32-bit
    values, broadcast together) under the key (k0, k1): four such tensors."""
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _words(key: tuple, rows: torch.Tensor, first: int, blocks: int) -> torch.Tensor:
    """(len(rows), 4 · blocks) int64: words 4·first … 4·(first + blocks) − 1
    of each row's stream."""
    b = torch.arange(first, first + blocks, dtype=torch.int64, device=rows.device)[None, :]
    r = rows[:, None]
    lanes = philox4x32_10(key, b, r & MASK32, r >> 32, torch.zeros_like(b))
    return torch.stack(torch.broadcast_tensors(*lanes), dim=-1).reshape(len(rows), 4 * blocks)


def permdraw_ref(key: tuple, t: int, n: int, *, device) -> torch.Tensor:
    """(t, n) int64: row r a uniform permutation of 0..n-1 drawn from the
    words of (key, r) alone."""
    out = torch.arange(n, device=device).repeat(t, 1)
    if t == 0 or n < 2:
        return out
    rows = torch.arange(t, device=device)
    buf = _words(key, rows, 0, -(-(n - 1) // 4))     # the n − 1 words of no rejection
    used = torch.zeros(t, dtype=torch.int64, device=device)   # words each row has taken
    most = 0                                                    # a bound on used.max()
    j = torch.empty((t, 1), dtype=torch.int64, device=device)
    for i in range(n - 1, 0, -1):
        s = i + 1
        threshold = (1 << 32) % s           # Lemire: reject a low half below 2^32 mod s
        todo = rows
        while todo.numel():
            most += 1
            if most > buf.shape[1]:
                buf = torch.cat([buf, _words(key, rows, buf.shape[1] // 4, 1)], dim=1)
            m = buf[todo, used[todo]] * s
            used[todo] += 1
            ok = (m & MASK32) >= threshold
            j[todo[ok], 0] = m[ok] >> 32
            todo = todo[~ok]
        a = out[:, i:i + 1].clone()
        out[:, i:i + 1] = out.gather(1, j)
        out.scatter_(1, j, a)
    return out
