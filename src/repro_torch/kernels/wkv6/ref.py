"""Plain PyTorch WKV6 recurrence: the CPU path of :mod:`.ops` and what the
CUDA kernel is held against on the card.  The JAX package's
``models/rwkv.py::wkv6_scan``, step for step, in the model layout."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             s0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v (B, S, H, n); w (B, S, H, n) decays in (0, 1); u (H, n);
    s0 (B, H, n, n) or None (zeros).  Returns (y (B, S, H, n) float32,
    s_final (B, H, n, n) float32); state layout s[k_dim, v_dim]."""
    B, S, H, n = r.shape
    r32, k32, v32, w32 = (t.float() for t in (r, k, v, w))
    u32 = u.float()
    s = (torch.zeros((B, H, n, n), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    ys = []
    for t in range(S):
        rt, kt, vt, wt = r32[:, t], k32[:, t], v32[:, t], w32[:, t]
        y = torch.einsum("bhk,bhkv->bhv", rt, s)
        y = y + vt * torch.sum(rt * (u32 * kt), dim=-1, keepdim=True)
        s = wt[..., None] * s + kt[..., None] * vt[:, :, None, :]
        ys.append(y)
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((B, 0, H, n), dtype=torch.float32, device=r.device))
    return y, s


#: the chunked kernel's chunk and sub-chunk lengths (``csrc/wkv6.cu``)
CHUNK = 64
SUB = 16


def wkv6_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     s0: Optional[torch.Tensor] = None, chunk: int = CHUNK,
                     sub: int = SUB) -> Tuple[torch.Tensor, torch.Tensor]:
    """A plain float32 model of the chunked kernel's arithmetic, same
    contract as :func:`wkv6_ref`; the tests hold it against the serial
    recurrence.  Every decay is a sequential product of w, never an exp
    of cumulated log w (w may be 0).  Steps past S are padded with w = 1
    and r = k = v = 0, which change nothing.  With chunks c of ``chunk``
    steps, sub-chunks p of ``sub`` steps, and for step t of sub-chunk p:
    a_t = prod of w over [start of p, t), b_t = prod over (t, end of p),
    g_p = prod over p, G_pre/G_suf = prod of g over the sub-chunks
    before/after p:

    (i)   per chunk: P = prod of all its w, and
          dS = sum_s (k_s * b_s * G_suf)(v_s)^T;
    (ii)  per (b, h), over chunks in order: S_c, then
          S_{c+1} = diag(P_c) S_c + dS_c;
    (iii) y_t = (r_t * a_t * G_pre) . S_c + sum_{s<t} A[t,s] v_s
          + v_t (r_t . (u * k_t)), where A[t,s] for s in an earlier
          sub-chunk q is (r_t * a_t * prod_{q<m<p} g_m) . (k_s * b_s),
          and within a sub-chunk sum_i r_t k_s prod_{s<tau<t} w_tau by
          a running product."""
    B, S, H, n = r.shape
    dev = r.device
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def blocks(t, fill):
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_full((B, pad, H, n), fill)], dim=1)
        # (B, H, nc, nsub, sub, n)
        return t.permute(0, 2, 1, 3).reshape(B, H, nc, chunk // sub, sub, n)

    r32, k32, v32 = (blocks(t, 0.0) for t in (r, k, v))
    w32 = blocks(w, 1.0)
    u32 = u.float()[None, :, None, None, None, :]
    nsub = chunk // sub
    a = torch.ones_like(w32)
    for t in range(1, sub):
        a[..., t, :] = a[..., t - 1, :] * w32[..., t - 1, :]
    g = a[..., sub - 1, :] * w32[..., sub - 1, :]          # (.., nsub, n)
    b_ = torch.ones_like(w32)
    for t in range(sub - 2, -1, -1):
        b_[..., t, :] = b_[..., t + 1, :] * w32[..., t + 1, :]
    g_pre = torch.ones_like(g)
    for p in range(1, nsub):
        g_pre[..., p, :] = g_pre[..., p - 1, :] * g[..., p - 1, :]
    g_suf = torch.ones_like(g)
    for p in range(nsub - 2, -1, -1):
        g_suf[..., p, :] = g_suf[..., p + 1, :] * g[..., p + 1, :]
    P = g_pre[..., nsub - 1, :] * g[..., nsub - 1, :]        # (B, H, nc, n)
    r_hat, k_hat = r32 * a, k32 * b_
    r_til = r_hat * g_pre[..., None, :]
    k_til = k_hat * g_suf[..., None, :]

    def flat(t):                                  # (B, H, nc, chunk, n)
        return t.reshape(B, H, nc, chunk, n)

    dS = torch.einsum("bhcsi,bhcsj->bhcij", flat(k_til), flat(v32))
    s = (torch.zeros((B, H, n, n), dtype=torch.float32, device=dev)
         if s0 is None else s0.float().clone())
    starts = []
    for c in range(nc):
        starts.append(s)
        s = P[:, :, c, :, None] * s + dS[:, :, c]
    S_c = torch.stack(starts, dim=2)                       # (B, H, nc, n, n)
    y = torch.einsum("bhcti,bhcij->bhctj", flat(r_til), S_c)

    A = torch.zeros((B, H, nc, chunk, chunk), dtype=torch.float32,
                    device=dev)
    for p in range(nsub):
        tp = slice(p * sub, (p + 1) * sub)
        mid = torch.ones_like(g[..., 0, :])
        for q in range(p - 1, -1, -1):              # q = p-1 first: mid 1
            A[..., tp, q * sub:(q + 1) * sub] = torch.einsum(
                "bhcti,bhcsi->bhcts", r_hat[..., p, :, :] * mid[..., None, :],
                k_hat[..., q, :, :])
            mid = mid * g[..., q, :]
        rp, kp, wp = r32[..., p, :, :], k32[..., p, :, :], w32[..., p, :, :]
        for t in range(sub):
            prod = torch.ones_like(wp[..., 0, :])
            for s_ in range(t - 1, -1, -1):
                A[..., p * sub + t, p * sub + s_] = torch.sum(
                    rp[..., t, :] * (prod * kp[..., s_, :]), dim=-1)
                prod = prod * wp[..., s_, :]
            A[..., p * sub + t, p * sub + t] = torch.sum(
                rp[..., t, :] * (u32[..., 0, 0, :] * kp[..., t, :]), dim=-1)
    y = y + torch.einsum("bhcts,bhcsj->bhctj", A, flat(v32))
    y = y.reshape(B, H, nc * chunk, n)[:, :, :S].permute(0, 2, 1, 3)
    return y.contiguous(), s
