"""Plain PyTorch RG-LRU scan: the CPU path of :mod:`.ops` and what the
CUDA kernel is held against on the card.  The JAX package's
``kernels/rglru/ref.py::rglru_scan_ref``: a float32 loop over time, and
its gradient (:func:`rglru_scan_bwd_ref`), what the backward kernel is
held against."""
from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t-1} + b_t from h = 0 (so h_0 = b_0).  a, b
    (B, S, C) -> h (B, S, C) float32."""
    a32, b32 = a.float(), b.float()
    h = torch.zeros_like(b32[:, 0])
    out = torch.empty_like(b32)
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        out[:, t] = h
    return out


def rglru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor,
                       dh: torch.Tensor) -> tuple:
    """The gradients (da, db) of :func:`rglru_scan_ref` for the output
    gradient ``dh``, ``h`` being its output: a reverse scan g_t = dh_t +
    a_{t+1} ⊙ g_{t+1} (g past the end 0), db_t = g_t, da_t = g_t ⊙
    h_{t-1} with h_{-1} = 0.  All (B, S, C) float32."""
    a32, h32, dh32 = a.float(), h.float(), dh.float()
    da, db = torch.empty_like(dh32), torch.empty_like(dh32)
    carry = torch.zeros_like(dh32[:, 0])                    # a_{t+1} g_{t+1}
    for t in range(a.shape[1] - 1, -1, -1):
        g = dh32[:, t] + carry
        db[:, t] = g
        da[:, t] = g * h32[:, t - 1] if t else 0.0
        carry = a32[:, t] * g
    return da, db


#: the backward kernel's time chunk (steps a block) and sub-chunk (steps
#: a warp) (``csrc/rglru_scan_bwd.cu``)
CHUNK = 128
SUB = 16


def rglru_scan_bwd_chunked_ref(a: torch.Tensor, h: torch.Tensor,
                               dh: torch.Tensor, chunk: int = CHUNK,
                               sub: int = SUB) -> tuple:
    """A plain float32 model of the backward kernel's arithmetic, same
    contract as :func:`rglru_scan_bwd_ref`; the tests hold it against
    the serial scan.  Time is cut into chunks of ``chunk`` steps and
    those into sub-chunks of ``sub`` steps (steps past S padded with a =
    dh = 0).  With C the carry a_{t+1} g_{t+1} that enters a stretch of
    steps from the later ones:

    (i)   per sub-chunk, the reverse scan from a zero carry gives g^loc;
          its aggregate is P = prod a over it and L = a_first g^loc_first,
          so the carry it passes on is L + P C;
    (ii)  per chunk, the sub-chunks' aggregates composed from the last:
          (P, L) <- (P_q P, L_q + P_q L);
    (iii) over chunks from the last, from a zero carry: each chunk's
          carry in C_c, and C_{c-1} = L_c + P_c C_c;
    (iv)  inside a chunk the sub-chunks' carries from C_c, C_{q-1} = L_q
          + P_q C_q, and each sub-chunk's scan g_t = dh_t + a_{t+1}
          g_{t+1} from its carry; db_t = g_t, da_t = g_t h_{t-1}."""
    B, S, C = a.shape
    nc = -(-S // chunk)
    nsub = chunk // sub
    pad = nc * chunk - S
    a32, h32, dh32 = a.float(), h.float(), dh.float()
    h_prev = torch.cat([torch.zeros_like(h32[:, :1]), h32[:, :-1]], dim=1)

    def blocks(t):                              # (B, nc, nsub, sub, C)
        if pad:
            t = torch.cat([t, t.new_zeros((B, pad, C))], dim=1)
        return t.reshape(B, nc, nsub, sub, C)

    ab, gb = blocks(a32), blocks(dh32)

    def walk(carry):
        """The sub-chunks' reverse scans from ``carry`` (B, nc, nsub, C)."""
        g = torch.empty_like(gb)
        x = gb[..., sub - 1, :] + carry
        g[..., sub - 1, :] = x
        for t in range(sub - 2, -1, -1):
            x = ab[..., t + 1, :] * x + gb[..., t, :]
            g[..., t, :] = x
        return g

    g_loc = walk(torch.zeros_like(gb[..., 0, :]))
    L_q = ab[..., 0, :] * g_loc[..., 0, :]                # (B, nc, nsub, C)
    P_q = ab[..., 0, :].clone()
    for t in range(1, sub):
        P_q = P_q * ab[..., t, :]
    P_c = torch.ones_like(P_q[:, :, 0])
    L_c = torch.zeros_like(L_q[:, :, 0])
    for q in range(nsub - 1, -1, -1):
        L_c = L_q[:, :, q] + P_q[:, :, q] * L_c
        P_c = P_q[:, :, q] * P_c
    carry_c = torch.zeros_like(P_c)                       # (B, nc, C)
    for c in range(nc - 1, 0, -1):
        carry_c[:, c - 1] = L_c[:, c] + P_c[:, c] * carry_c[:, c]
    carry_q = torch.empty_like(P_q)
    x = carry_c
    for q in range(nsub - 1, -1, -1):
        carry_q[:, :, q] = x
        x = L_q[:, :, q] + P_q[:, :, q] * x
    g = walk(carry_q).reshape(B, nc * chunk, C)[:, :S]
    return g * h_prev, g.contiguous()
