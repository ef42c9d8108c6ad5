"""Plain PyTorch WKV6 recurrence: the CPU path of :mod:`.ops` and what the
CUDA kernel is held against on the card.  The JAX package's
``models/rwkv.py::wkv6_scan``, step for step, in the model layout, and
its gradient (:func:`wkv6_bwd_ref`), what the backward kernel is held
against."""
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


def wkv6_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, s0: Optional[torch.Tensor],
                 dy: torch.Tensor, ds: Optional[torch.Tensor] = None
                 ) -> tuple:
    """The gradients (dr, dk, dv, dw, du, ds0) of :func:`wkv6_ref` for
    the output gradients ``dy`` (B, S, H, n) and ``ds`` (the final
    state's, or None for zeros), each in its input's dtype (ds0 float32,
    None when s0 is None).  With S_t the state after step t (S_{-1} =
    s0) and Ĝ_t = ∂L/∂S_t carried backwards from Ĝ_{S-1} = ds:
    Ĝ_{t-1} = diag(w_t) Ĝ_t + r_t dy_tᵀ, dr_t = S_{t-1} dy_t + u ⊙ k_t
    (v_t·dy_t), dk_t = Ĝ_t v_t + u ⊙ r_t (v_t·dy_t), dv_t = Ĝ_tᵀ k_t +
    (r_t·(u ⊙ k_t)) dy_t, dw_t = rowsum(Ĝ_t ⊙ S_{t-1}), du = Σ_t r_t ⊙
    k_t (v_t·dy_t), ds0 = Ĝ_{-1}.  No division by w (it may be 0): the
    states come from a forward re-run."""
    B, S, H, n = r.shape
    r32, k32, v32, w32, dy32 = (t.float() for t in (r, k, v, w, dy))
    u32 = u.float()
    s = (torch.zeros((B, H, n, n), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    prev = []                                     # S_{t-1} for each t
    for t in range(S):
        prev.append(s)
        s = w32[:, t, ..., None] * s + k32[:, t, ..., None] * v32[:, t, :,
                                                                  None, :]
    G = (torch.zeros_like(s) if ds is None else ds.float().clone())
    dr, dk, dv, dw = (torch.empty_like(t) for t in (r32, k32, v32, w32))
    du = torch.zeros_like(u32)
    for t in range(S - 1, -1, -1):
        rt, kt, vt, wt, dyt = (x[:, t] for x in (r32, k32, v32, w32, dy32))
        sp = prev[t]
        vdy = torch.sum(vt * dyt, dim=-1, keepdim=True)         # (B, H, 1)
        ruk = torch.sum(rt * (u32 * kt), dim=-1, keepdim=True)
        dr[:, t] = torch.einsum("bhij,bhj->bhi", sp, dyt) + u32 * kt * vdy
        dk[:, t] = torch.einsum("bhij,bhj->bhi", G, vt) + u32 * rt * vdy
        dv[:, t] = torch.einsum("bhij,bhi->bhj", G, kt) + dyt * ruk
        dw[:, t] = torch.sum(G * sp, dim=-1)
        du = du + torch.sum(rt * kt * vdy, dim=0)
        G = wt[..., None] * G + rt[..., None] * dyt[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.to(u.dtype), None if s0 is None else G)


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


def wkv6_chunked_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         w: torch.Tensor, u: torch.Tensor,
                         s0: Optional[torch.Tensor], dy: torch.Tensor,
                         ds: Optional[torch.Tensor] = None,
                         chunk: int = CHUNK, sub: int = SUB) -> tuple:
    """A plain float32 model of the chunked backward kernel's arithmetic
    (``csrc/wkv6_bwd.cu``, chunked body), same contract as
    :func:`wkv6_bwd_ref`; the tests hold it against the serial gradient.
    Every decay is a sequential product of w (no exp of a cumulated log,
    no log, no division: w may be 0 or 1).  Steps past S are padded with
    w = 1 and r = k = v = dy = 0, which change nothing.

    (i)   per chunk, as the forward's (i): P = prod w, dS = sum_s (k_s *
          b_s * G_suf) v_s^T; and dG = sum_t (r_t * a_t * G_pre) dy_t^T,
          the gradient before the chunk from a zero gradient after it;
    (ii)  per (b, h), over chunks: the start states S_c forward from s0,
          S_{c+1} = diag(P_c) S_c + dS_c, and the gradients after each
          chunk backward from ds, Ĝ_{c-1} = diag(P_c) Ĝ_c + dG_c; ds0 is
          the last;
    (iii) per chunk, the state before each sub-chunk p (S_0 = S_c,
          S_{p+1} = diag(g_p) S_p + sum_{s in p} (k_s * b_s) v_s^T) and
          the gradient after it (G_3 = Ĝ_c, G_{p-1} = diag(g_p) G_p +
          sum_{t in p} (r_t * a_t) dy_t^T); then for step t of p, with
          D(s, t) the product of w strictly between s and t, X1_t = S_p
          dy_t, X2_t = G_p v_t, M[t, s] = dy_t . v_s and A[t, s] = r_t .
          (D(s, t) * k_s) (A[t, t] = r_t . (u * k_t)):
          dr_t = a_t X1_t + sum_{s<t} M[t,s] D(s,t) k_s + u k_t M[t,t]
          dk_t = b_t X2_t + sum_{s>t} M[s,t] D(t,s) r_s + u r_t M[t,t]
          dv_t = G_p^T (b_t k_t) + sum_{s>=t} A[s,t] dy_s
          dw_t = a_t b_t rowsum(G_p * S_p)
                 + a_t sum_{s>t} D(t,s) r_s X1_s
                 + b_t sum_{s<t} D(s,t) k_s X2_s
                 + sum_{s<t<s'} D(s,t) D(t,s') k_s r_s' M[s',s]
          du = sum_t r_t k_t M[t,t],
          sums over s, s' inside p, each D a running product of w, and
          the cross term's product over (s, s') less t formed only as
          D(s,t) D(t,s')."""
    B, S, H, n = r.shape
    dev = r.device
    nc = -(-S // chunk)
    nsub = chunk // sub
    pad = nc * chunk - S

    def blocks(t, fill):
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_full((B, pad, H, n), fill)], dim=1)
        # (B, H, nc, nsub, sub, n)
        return t.permute(0, 2, 1, 3).reshape(B, H, nc, nsub, sub, n)

    r32, k32, v32, dy32 = (blocks(t, 0.0) for t in (r, k, v, dy))
    w32 = blocks(w, 1.0)
    u32 = u.float()[None, :, None, :]                       # (1, H, 1, n)
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

    def flat(t):                                  # (B, H, nc, chunk, n)
        return t.reshape(B, H, nc, chunk, n)

    # (i) and (ii)
    dS = torch.einsum("bhcsi,bhcsj->bhcij",
                      flat(k_hat * g_suf[..., None, :]), flat(v32))
    dG = torch.einsum("bhcsi,bhcsj->bhcij",
                      flat(r_hat * g_pre[..., None, :]), flat(dy32))
    s = (torch.zeros((B, H, n, n), dtype=torch.float32, device=dev)
         if s0 is None else s0.float().clone())
    starts = []
    for c in range(nc):
        starts.append(s)
        s = P[:, :, c, :, None] * s + dS[:, :, c]
    G = (torch.zeros((B, H, n, n), dtype=torch.float32, device=dev)
         if ds is None else ds.float().clone())
    ends = [None] * nc
    for c in range(nc - 1, -1, -1):
        ends[c] = G
        G = P[:, :, c, :, None] * G + dG[:, :, c]
    S_p = [torch.stack(starts, dim=2)]                     # (B, H, nc, n, n)
    for p in range(nsub - 1):
        S_p.append(g[..., p, :, None] * S_p[-1] + torch.einsum(
            "bhcsi,bhcsj->bhcij", k_hat[..., p, :, :], v32[..., p, :, :]))
    G_p = [torch.stack(ends, dim=2)]
    for p in range(nsub - 1, 0, -1):
        G_p.insert(0, g[..., p, :, None] * G_p[0] + torch.einsum(
            "bhcsi,bhcsj->bhcij", r_hat[..., p, :, :], dy32[..., p, :, :]))

    # (iii)
    dr, dk, dv, dw = (torch.empty_like(r32) for _ in range(4))
    du = torch.zeros_like(r32[..., 0, 0, :])                # (B, H, nc, n)
    for p in range(nsub):
        rp, kp, vp, wp, dyp = (x[..., p, :, :]
                               for x in (r32, k32, v32, w32, dy32))
        Sm, Gm = S_p[p], G_p[p]
        X1 = torch.einsum("bhcij,bhctj->bhcti", Sm, dyp)
        X2 = torch.einsum("bhcij,bhctj->bhcti", Gm, vp)
        X3 = torch.einsum("bhcij,bhcti->bhctj", Gm, k_hat[..., p, :, :])
        rho = torch.sum(Gm * Sm, dim=-1)                    # (B, H, nc, n)
        M = torch.einsum("bhctj,bhcsj->bhcts", dyp, vp)
        A = torch.zeros_like(M)
        for t in range(sub):
            prod = torch.ones_like(wp[..., 0, :])
            for s_ in range(t - 1, -1, -1):
                A[..., t, s_] = torch.sum(rp[..., t, :] * (prod * kp[..., s_, :]),
                                          dim=-1)
                prod = prod * wp[..., s_, :]
            A[..., t, t] = torch.sum(rp[..., t, :] * (u32 * kp[..., t, :]),
                                     dim=-1)
        dv[..., p, :, :] = X3 + torch.einsum("bhcst,bhcsj->bhctj",
                                             torch.tril(A), dyp)
        for t in range(sub):
            bonus = M[..., t, t, None]
            # s < t: D(s, t) as a running product from s = t - 1 down
            acc_r, acc_w3 = u32 * kp[..., t, :] * bonus, 0.0
            prod, c = torch.ones_like(wp[..., 0, :]), []
            for s_ in range(t - 1, -1, -1):
                cs = prod * kp[..., s_, :]
                c.append(cs)
                acc_r = acc_r + M[..., t, s_, None] * cs
                acc_w3 = acc_w3 + cs * X2[..., s_, :]
                prod = prod * wp[..., s_, :]
            a_t = prod
            # s' > t: D(t, s') from s' = t + 1 up, with the cross term
            acc_k, acc_w2, cross = u32 * rp[..., t, :] * bonus, 0.0, 0.0
            prod = torch.ones_like(wp[..., 0, :])
            for s2 in range(t + 1, sub):
                d = prod * rp[..., s2, :]
                acc_k = acc_k + M[..., s2, t, None] * d
                acc_w2 = acc_w2 + d * X1[..., s2, :]
                inner = 0.0
                for j, cs in enumerate(c):               # s = t - 1 - j
                    inner = inner + cs * M[..., s2, t - 1 - j, None]
                cross = cross + d * inner
                prod = prod * wp[..., s2, :]
            b_t = prod
            dr[..., p, t, :] = a_t * X1[..., t, :] + acc_r
            dk[..., p, t, :] = b_t * X2[..., t, :] + acc_k
            dw[..., p, t, :] = (a_t * b_t * rho + a_t * acc_w2
                                + b_t * acc_w3 + cross)
            du = du + rp[..., t, :] * kp[..., t, :] * bonus

    def unblock(t):                                    # -> (B, S, H, n)
        return t.reshape(B, H, nc * chunk, n)[:, :, :S].permute(0, 2, 1, 3)

    return (unblock(dr).to(r.dtype), unblock(dk).to(k.dtype),
            unblock(dv).to(v.dtype), unblock(dw).contiguous().to(w.dtype),
            du.sum(dim=(0, 2)).to(u.dtype), None if s0 is None else G)
