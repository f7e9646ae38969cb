"""Plain PyTorch versions of the LM kernels (the allclose targets).

`matmul_ref` and `flash_attention_ref` are copies of `repro.kernels.ref`:
the tests and `chip_smoke.py` hold the CUDA kernels against them, and the
kernel wrappers take them for CPU tensors.  `flash_attention_rounded_ref`
holds K3's bf16 instance to a tighter bar.  `flash_attention_lse_ref` and
`flash_attention_bwd_ref` are the plain versions of K3's forward with its
log-sum-exp and of its backward (K3-bwd), which the reference computes by
autodiff of `flash_sdpa` and has no kernel for.  Nothing on the card's
serving or training path calls them.
"""

from __future__ import annotations

import torch


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float | None = None,
                        sk_valid: int | None = None) -> torch.Tensor:
    """Causal GQA attention with materialised scores in f32.
    q: (B,Sq,H,hd); k,v: (B,Sk,KV,hd) -> (B,Sq,H,hd) in q's dtype.

    `scale` (default hd^-0.5) and `sk_valid` (default Sk: keys at or past it
    are masked) are the K3 kernel's own arguments, for holding its padded
    problem (`flash_attention.pad_operands`) to the unpadded one."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    g = H // KV
    qq = q.reshape(B, Sq, KV, g, hd).float()
    scale = hd ** -0.5 if scale is None else scale
    s = torch.einsum("bqkgh,bskh->bkgqs", qq, k.float()) * scale
    keys = torch.arange(Sk, device=q.device)[None, :]
    mask = keys <= torch.arange(Sq, device=q.device)[:, None]
    if sk_valid is not None:
        mask &= keys < sk_valid
    s = torch.where(mask, s, float("-inf"))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def flash_attention_rounded_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor) -> torch.Tensor:
    """`flash_attention_ref` with the flash kernels' roundings (the Pallas
    kernel's and K3's), untiled: p = exp(s - rowmax) is rounded to v's dtype
    before the PV product, l sums the unrounded p in f32, and out =
    acc / max(l, 1e-30) is rounded once to q's dtype.  In bf16 it differs
    from a flash kernel only by where p was rounded (against the running
    max, not the row's), so it takes a tighter bar than the plain version."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    g = H // KV
    qq = q.reshape(B, Sq, KV, g, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qq, k.float()) * hd ** -0.5
    mask = (torch.arange(Sk, device=q.device)[None, :]
            <= torch.arange(Sq, device=q.device)[:, None])
    s = torch.where(mask, s, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgqs,bskh->bkgqh", p.to(v.dtype).float(), v.float())
    out = (acc / l.clamp(min=1e-30)).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _masked_scores(q, k, scale, sk_valid):
    """Scaled f32 scores (B, KV, g, Sq, Sk) of q (B,Sq,H,hd) against k
    (B,Sk,KV,hd) and the visibility mask (Sq, Sk): key j is seen by query i
    when j <= i and j < sk_valid."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qq = q.reshape(B, Sq, KV, H // KV, hd).float()
    scale = hd ** -0.5 if scale is None else scale
    s = torch.einsum("bqkgh,bskh->bkgqs", qq, k.float()) * scale
    keys = torch.arange(Sk, device=q.device)[None, :]
    mask = keys <= torch.arange(Sq, device=q.device)[:, None]
    if sk_valid is not None:
        mask &= keys < sk_valid
    return s, mask


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, scale: float | None = None,
                            sk_valid: int | None = None):
    """`flash_attention_ref` and each row's log-sum-exp of the scaled, masked
    scores (natural log), as K3 writes it for training: (out (B,Sq,H,hd) in
    q's dtype, lse (B,H,Sq) f32)."""
    B, Sq, H, hd = q.shape
    s, mask = _masked_scores(q, k, scale, sk_valid)
    s = torch.where(mask, s, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    w = torch.exp(s - lse[..., None])
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return (out.reshape(B, Sq, H, hd).to(q.dtype),
            lse.reshape(B, H, Sq))


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, scale: float | None = None,
                            sk_valid: int | None = None):
    """dQ, dK, dV of causal GQA attention from the forward's output `o` and
    log-sum-exp `lse` (B,H,Sq) f32, for the output gradient `do`, with
    materialised f32 scores (the FlashAttention-2 equations K3-bwd runs):
    P = exp(scale QK^T - lse) (0 where masked), D = rowsum(dO o O), dV = P^T
    dO, dS = P (dO V^T - D), dQ = scale dS K, dK = scale dS^T Q; the sums over
    a KV head's g query heads are taken here too.  Each gradient in its
    operand's dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = hd ** -0.5 if scale is None else scale
    s, mask = _masked_scores(q, k, scale, sk_valid)
    p = torch.where(mask, torch.exp(s - lse.reshape(B, KV, g, Sq, 1)), 0.0)
    qq = q.reshape(B, Sq, KV, g, hd).float()
    dd = do.reshape(B, Sq, KV, g, hd).float()
    oo = o.reshape(B, Sq, KV, g, hd).float()
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dd)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dd, v.float())
    delta = (dd * oo).sum(dim=-1).permute(0, 2, 3, 1)      # (B, KV, g, Sq)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qq) * scale
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
