"""Plain PyTorch versions of flash attention, in the flattened
``(B*H, S, hd)`` layout of the JAX package's references.

  * :func:`attention_ref` — the naive softmax oracle (normalize, then
    multiply by V).
  * :func:`flash_attention_mirror` — the kernel's tiled arithmetic: q tiles
    of ``bq`` rows, K/V tiles of ``bk`` rows (the last of each may be
    short, as the CUDA kernel masks its ragged edge), the same running-max
    rescaling, masked scores at -1e30, K/V tiles past the causal bound
    never read, and the final ``acc / max(l, 1e-30)``.

:func:`flash_attention_plain` is the mirror in the public ``(B, S, H, hd)``
layout, with the JAX wrapper's GQA head repeat: the plain version of the
kernel.

All use the decode convention: when ``Sq < Sk`` the q rows are the suffix
of the key sequence (causal masking offsets q positions by ``Sk - Sq``).
Arithmetic is float32 whatever the input type; the result has the input's
type.
"""
import math

import torch

MASKED = -1e30


def attention_ref(q, k, v, *, causal=True):
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    s = torch.einsum("bqh,bkh->bqk", q.float(), k.float()) / math.sqrt(hd)
    if causal:
        q_pos = (Sk - Sq) + torch.arange(Sq, device=q.device)
        mask = q_pos[:, None] >= torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(mask[None], s, torch.full_like(s, MASKED))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", p, v.float()).to(q.dtype)


def flash_attention_mirror(q, k, v, *, causal=True, bq=64, bk=64):
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    if causal and Sq > Sk:
        raise ValueError(
            f"causal attention needs Sq <= Sk (q is the kv suffix); "
            f"got Sq={Sq} Sk={Sk}")
    q_offset = Sk - Sq
    nk_all = -(-Sk // bk)
    dev = q.device
    out = []
    for q0 in range(0, Sq, bq):
        qt = q[:, q0:q0 + bq].float() * (1.0 / math.sqrt(hd))
        rows = qt.shape[1]
        m = torch.full((BH, rows), -math.inf, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((BH, rows), dtype=torch.float32, device=dev)
        acc = torch.zeros((BH, rows, hd), dtype=torch.float32, device=dev)
        q_pos = q_offset + q0 + torch.arange(rows, device=dev)
        nk = min((q_offset + q0 + bq + bk - 1) // bk, nk_all) if causal \
            else nk_all
        for j in range(nk):
            kt = k[:, j * bk:(j + 1) * bk].float()
            vt = v[:, j * bk:(j + 1) * bk].float()
            s = torch.einsum("bqh,bkh->bqk", qt, kt)
            if causal:
                k_pos = j * bk + torch.arange(kt.shape[1], device=dev)
                keep = q_pos[None, :, None] >= k_pos[None, None, :]
                s = torch.where(keep, s, torch.full_like(s, MASKED))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            scale = torch.exp(m - m_new)
            l = l * scale + p.sum(dim=-1)
            acc = acc * scale[..., None] + torch.einsum("bqk,bkh->bqh", p, vt)
            m = m_new
        out.append((acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype))
    return torch.cat(out, dim=1)


def flash_attention_plain(q, k, v, *, causal=True, bq=64, bk=64):
    """q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd) -> (B,Sq,H,hd): the JAX wrapper's
    GQA repeat and flattening around :func:`flash_attention_mirror`."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]

    def flat(t, s):
        return t.repeat_interleave(H // KV, dim=2).permute(0, 2, 1, 3) \
            .reshape(B * H, s, hd)

    o = flash_attention_mirror(q.permute(0, 2, 1, 3).reshape(B * H, Sq, hd),
                               flat(k, Sk), flat(v, Sk), causal=causal,
                               bq=bq, bk=bk)
    return o.reshape(B, H, Sq, hd).permute(0, 2, 1, 3)
