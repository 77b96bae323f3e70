"""Plain PyTorch version of the flash_attention kernel: dense masked
softmax attention with GQA, local windows and logit soft-capping.

Also the attention of the model trunk on CPU tensors (the wrapper in
``ops.py`` takes it only there).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, S, D); k, v: (B, Hkv, S_kv, D). Returns (B, Hq, S, D).

    All math in float32, cast back to q's dtype. Query i sits at absolute
    position i + (S_kv − S) (the decode offset: the ends are aligned).
    """
    b, hq, s, d = q.shape
    hkv, s_kv = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, s, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    q_idx = torch.arange(s, device=q.device)[:, None] + (s_kv - s)
    k_idx = torch.arange(s_kv, device=q.device)[None, :]
    mask = torch.ones((s, s_kv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_idx >= k_idx
    if window is not None:
        mask &= (q_idx - k_idx) < window
    logits = torch.where(mask, logits, torch.tensor(NEG_INF, dtype=logits.dtype,
                                                    device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, hq, s, d).to(q.dtype)
