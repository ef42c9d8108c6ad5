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

On a mesh (``env``; ``params`` this rank's slices,
``interop.shard_lm_params``) both halves run under the env, as the
reference's ``device_prefix``/``edge_suffix`` take it: each rank takes
its rows of the batch (``transformer.serving_rows``), keeps its piece of
every cache under ``transformer.cache_specs`` and returns its vocab
shard of the logits; the server gathers the next tokens over the batch
axes, so every rank returns the same tokens.

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
from repro_torch.runtime.meshenv import CPU_ENV, MeshEnv

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
                  caches: Optional[List] = None, pos=None,
                  env: MeshEnv = CPU_ENV, specs: Optional[List] = None):
    """The device half: embedding and blocks [0, split).  Returns (w_s
    activation (B, S, d), device caches).

    mode ``prefill``: tokens (B, S).  mode ``decode``: tokens (B, 1), pos
    the position, caches required (updated in place).  On a mesh,
    ``tokens`` are this rank's rows, ``env`` the env its model code runs
    under and ``specs`` the caches' (``transformer.cache_specs`` of the
    blocks [0, split))."""
    h = tfm._embed_tokens(cfg, params, tokens, env)
    positions = pos if mode == "decode" else tfm._positions(tokens)
    return tfm.apply_stack(cfg, params, h, mode=mode, positions=positions,
                           caches=caches, cache_len=cache_len, lo=0,
                           hi=split, env=env, specs=specs)


def edge_suffix(cfg: ModelConfig, params: Params, h_split: torch.Tensor,
                split: int, *, mode: str = "prefill", cache_len: int = 0,
                caches: Optional[List] = None, pos=None,
                env: MeshEnv = CPU_ENV, specs: Optional[List] = None):
    """The edge half: blocks [split, M) and the head, from the shipped
    activation.  Returns (logits (B, Vp), next token (B,), edge caches);
    on a mesh (``env``, ``specs`` as :func:`device_prefix`'s, of the
    blocks [split, M)) the rank's rows and its vocab shard of the
    logits."""
    positions = pos if mode == "decode" else tfm._positions(h_split)
    h, new_caches = tfm.apply_stack(cfg, params, h_split, mode=mode,
                                    positions=positions, caches=caches,
                                    cache_len=cache_len, lo=split, env=env,
                                    specs=specs)
    logits, nxt = tfm.head(cfg, params, h[:, -1:], env)
    return logits, nxt, new_caches


def activation_bits(cfg: ModelConfig, batch: int, tokens: int) -> float:
    """Size of the shipped w_s payload (bf16 residual stream), in bits —
    the quantity the Li-GD cost model prices."""
    return float(batch * tokens * cfg.d_model * 16)


class SplitServer:
    """Executes MCSA-planned split inference for one model on ``device``
    (``None`` means the card, and raises without one; ``"cpu"`` takes the
    plain PyTorch path).  ``params`` must live on that device: the whole
    tree, or on a mesh (``env``) this rank's slices."""

    def __init__(self, cfg: ModelConfig, params: Params, device=None,
                 name: str = "edge", env: MeshEnv = CPU_ENV):
        tfm.check_supported(cfg, env)
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
        self.env = env
        self._specs: Optional[List] = None   # the caches' on a mesh
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
    def _rows(self, tokens: torch.Tensor) -> tuple:
        """(this rank's rows of the global ``tokens``, the env its model
        code runs under)."""
        if not self.env.is_spmd:
            return tokens, self.env
        rows, renv = tfm.serving_rows({"tokens": tokens}, self.env)
        return rows["tokens"], renv

    def _all_rows(self, nxt: torch.Tensor, renv: MeshEnv) -> torch.Tensor:
        """The next tokens of every row: gathered over the batch axes
        when the rows split over them."""
        if renv.is_spmd and renv.dp > 1:
            return self.env.all_gather(nxt, 0, renv.batch())
        return nxt

    def _run(self, tokens, split: int, caches, **kw) -> tuple:
        """Both halves on ``tokens`` (the global batch) -> (logits, every
        row's next tokens, (device caches, edge caches))."""
        rows, renv = self._rows(tokens)
        dev_caches, edge_caches = caches
        specs = self._specs
        h_split, dev_caches = device_prefix(
            self.cfg, self.params, rows, split, caches=dev_caches, env=renv,
            specs=None if specs is None else specs[:split], **kw)
        self._edge_guard()
        logits, nxt, edge_caches = edge_suffix(
            self.cfg, self.params, h_split, split, caches=edge_caches,
            env=renv, specs=None if specs is None else specs[split:], **kw)
        return logits, self._all_rows(nxt, renv), (dev_caches, edge_caches)

    def prefill(self, tokens, split: int, cache_len: int):
        """Split prefill: device prefix -> shipped w_s -> edge suffix.
        Raises :class:`ServerLostError` when the edge server is down (the
        device prefix runs regardless — it is local).  Returns (logits,
        next tokens, (device caches, edge caches)); on a mesh the logits
        are the rank's piece, the tokens every row's, and the caches this
        rank's slices, laid out by ``transformer.cache_specs`` of this
        batch and cache length (kept for :meth:`decode`)."""
        self._check_split(split)
        tokens = torch.as_tensor(tokens, device=self.device)
        if self.env.is_spmd:
            self._specs = tfm.cache_specs(self.cfg, self.env,
                                          tokens.shape[0],
                                          max(cache_len, tokens.shape[1]))
        return self._run(tokens, split, (None, None), cache_len=cache_len)

    def decode(self, token, pos, caches, split: int):
        """One split decode step; ``caches`` from this server's last
        :meth:`prefill` (updated in place)."""
        self._check_split(split)
        token = torch.as_tensor(token, device=self.device)
        return self._run(token, split, caches, mode="decode", pos=pos)

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
