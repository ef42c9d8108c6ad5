"""MCSA split execution for transformer LMs on one card.

The port of the JAX package's ``repro/serving/split.py``.  The paper's
"model-mule" (§3): the mobile device stores the whole model and computes
blocks ``[0, s)``; the residual activation at the split — the paper's
``w_s`` payload, (B, tokens, d_model) — ships to the edge server, which
computes blocks ``[s, M)`` and the LM head.  The split ``s`` comes from
the Li-GD planner on the transformer's own layer profile
(:func:`repro_torch.core.profile.profile_transformer`).

Both halves run on the server's ``device`` here (the card unless the
caller asks for the CPU): the split changes where blocks would run, not
the arithmetic, so split generation equals unsplit generation token for
token.  KV caches are split too: the device half holds its prefix
blocks' caches, the edge half the suffix's.  PyTorch runs eagerly, so
the reference's per-(split, mode) ``jax.jit`` cache has no counterpart.

Server loss mid-stream raises :class:`ServerLostError` from the edge
half; :meth:`SplitServer.generate_with_failover` relays the stream to a
fallback server and prices the relay-back (activation bits x hops /
bandwidth, Eq. 41's H₂ path).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm

from .failover import FailoverEvent, FailoverReport, ServerLostError

__all__ = ["SplitServer", "ServerLostError", "FailoverEvent",
           "FailoverReport", "layer_params", "device_prefix", "edge_suffix",
           "activation_bits"]

Params = dict


def layer_params(cfg: ModelConfig, params: Params, i: int) -> Params:
    """Weights of absolute block ``i``."""
    if not 0 <= i < cfg.num_layers:
        raise IndexError(f"block {i} outside [0, {cfg.num_layers})")
    return params["layers"][i]


def device_prefix(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                  split: int, *, mode: str = "prefill", cache_len: int = 0,
                  caches: Optional[List] = None, pos=None):
    """The device half: embedding and blocks [0, split).  Returns (w_s
    activation (B, S, d), device caches).

    mode ``prefill``: tokens (B, S).  mode ``decode``: tokens (B, 1), pos
    the position, caches required (updated in place)."""
    h = tfm._embed_tokens(cfg, params, tokens)
    positions = pos if mode == "decode" else tfm._positions(tokens)
    return tfm.apply_stack(cfg, params, h, mode=mode, positions=positions,
                           caches=caches, cache_len=cache_len, lo=0,
                           hi=split)


def edge_suffix(cfg: ModelConfig, params: Params, h_split: torch.Tensor,
                split: int, *, mode: str = "prefill", cache_len: int = 0,
                caches: Optional[List] = None, pos=None):
    """The edge half: blocks [split, M) and the head, from the shipped
    activation.  Returns (logits (B, Vp), next token (B,), edge caches)."""
    positions = pos if mode == "decode" else tfm._positions(h_split)
    h, new_caches = tfm.apply_stack(cfg, params, h_split, mode=mode,
                                    positions=positions, caches=caches,
                                    cache_len=cache_len, lo=split)
    logits, nxt = tfm.head(cfg, params, h[:, -1:])
    return logits, nxt, new_caches


def activation_bits(cfg: ModelConfig, batch: int, tokens: int) -> float:
    """Size of the shipped w_s payload (bf16 residual stream), in bits —
    the quantity the Li-GD cost model prices."""
    return float(batch * tokens * cfg.d_model * 16)


class SplitServer:
    """Executes MCSA-planned split inference for one model on ``device``
    (``None`` means the card, and raises without one; ``"cpu"`` takes the
    plain PyTorch path).  ``params`` must live on that device."""

    def __init__(self, cfg: ModelConfig, params: Params, device=None,
                 name: str = "edge"):
        tfm.check_supported(cfg)
        if cfg.enc_dec:
            raise ValueError(f"{cfg.name}: SplitServer serves decoder-only "
                             "stacks (its prefill takes tokens only, as "
                             "the reference's does)")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params on {params['embed'].device}, server "
                             f"on {self.device}")
        self.cfg = cfg
        self.params = params
        self.name = name
        self.up = True                    # edge-server liveness
        self._fail_after: Optional[int] = None

    # -- fault simulation -----------------------------------------------
    def fail(self, after_calls: Optional[int] = None) -> None:
        """Kill this edge server: immediately (default), or after
        ``after_calls`` more successful edge-side calls (each prefill or
        decode counts one)."""
        if after_calls is None:
            self.up = False
        else:
            self._fail_after = int(after_calls)

    def restore(self) -> None:
        """Bring the edge server back up."""
        self.up = True
        self._fail_after = None

    def _edge_guard(self) -> None:
        if self._fail_after is not None:
            self._fail_after -= 1
            if self._fail_after < 0:
                self.up = False
                self._fail_after = None
        if not self.up:
            raise ServerLostError(self.name)

    def _check_split(self, split: int) -> None:
        if not 0 <= split <= self.cfg.num_layers:
            raise ValueError(f"split {split} outside [0, "
                             f"{self.cfg.num_layers}]")

    # -- serving ----------------------------------------------------------
    def prefill(self, tokens, split: int, cache_len: int):
        """Split prefill: device prefix -> shipped w_s -> edge suffix.
        Raises :class:`ServerLostError` when the edge server is down (the
        device prefix runs regardless — it is local)."""
        self._check_split(split)
        tokens = torch.as_tensor(tokens, device=self.device)
        h_split, dev_caches = device_prefix(self.cfg, self.params, tokens,
                                            split, cache_len=cache_len)
        self._edge_guard()
        logits, nxt, edge_caches = edge_suffix(
            self.cfg, self.params, h_split, split, cache_len=cache_len)
        return logits, nxt, (dev_caches, edge_caches)

    def decode(self, token, pos, caches, split: int):
        """One split decode step; ``caches`` from :meth:`prefill` (updated
        in place)."""
        self._check_split(split)
        dev_caches, edge_caches = caches
        token = torch.as_tensor(token, device=self.device)
        h_split, dev_caches = device_prefix(
            self.cfg, self.params, token, split, mode="decode",
            caches=dev_caches, pos=pos)
        self._edge_guard()
        logits, nxt, edge_caches = edge_suffix(
            self.cfg, self.params, h_split, split, mode="decode",
            caches=edge_caches, pos=pos)
        return logits, nxt, (dev_caches, edge_caches)

    def generate(self, tokens, split: int, max_new: int,
                 cache_len: Optional[int] = None) -> torch.Tensor:
        """Greedy generation under a fixed split; returns (B, max_new)."""
        B, S = tokens.shape
        cache_len = cache_len or (S + max_new)
        _, nxt, caches = self.prefill(tokens, split, cache_len)
        out = [nxt]
        for i in range(max_new - 1):
            _, nxt, caches = self.decode(nxt[:, None], S + i, caches, split)
            out.append(nxt)
        return torch.stack(out, dim=1)

    def generate_with_failover(self, tokens, split: int, max_new: int, *,
                               fallbacks, hops_back: float = 1.0,
                               bandwidth_hz: float = 20e6,
                               cache_len: Optional[int] = None):
        """Greedy generation that survives mid-stream server loss.

        When a prefill or decode raises :class:`ServerLostError`, the
        stream relays to the next server in ``fallbacks``: the device
        re-ships its whole activation stream (prompt + every token
        generated so far) and the fallback re-prefills it, so no token is
        lost and the stream equals an uninterrupted one.  Each failover
        logs ``activation_bits(cfg, B, S + tokens_done) * hops_back /
        bandwidth_hz`` seconds of relay-back delay.

        Returns ``((B, max_new) tokens, FailoverReport)``; re-raises the
        last :class:`ServerLostError` when every fallback dies too."""
        tokens = torch.as_tensor(tokens, device=self.device)
        B, S = tokens.shape
        cache_len = cache_len or (S + max_new)
        queue = [self, *fallbacks]
        report = FailoverReport()
        produced: List[torch.Tensor] = []
        while True:
            srv = queue[0]
            seq = tokens if not produced else torch.cat(
                [tokens, torch.stack(produced, dim=1)], dim=1)
            try:
                _, nxt, caches = srv.prefill(seq, split, cache_len)
                produced.append(nxt)
                pos = seq.shape[1]
                while len(produced) < max_new:
                    _, nxt, caches = srv.decode(nxt[:, None], pos, caches,
                                                split)
                    produced.append(nxt)
                    pos += 1
                return torch.stack(produced, dim=1), report
            except ServerLostError as exc:
                queue.pop(0)
                if not queue:
                    raise
                bits = activation_bits(self.cfg, B, S + len(produced))
                report.events.append(FailoverEvent(
                    lost=exc.server, tokens_done=len(produced),
                    relay_s=bits * float(hops_back) / float(bandwidth_hz),
                    relay_bits=bits))
