"""Batched serving engine with grid-routed request placement.

Each *replica pool member* (a host group holding the model) is a site; each
request carries the artifacts it needs — a prefix-KV block id and/or a
LoRA-adapter id — registered as files. The router is the paper's scheduler:
send the request where the most required bytes already live, tie-break on
queue load; HRS replicates hot prefixes intra-pod first.

The compute side is a (prefill, decode) pair over the model facade, run
eagerly; the caches are allocated once at ``max_len`` and written in place
(the reference pads them after prefill). The engine serves token prompts,
as the reference's (a VLM config text-only); the encoder-decoder, whose
requests are frames, runs the same greedy loop through
:func:`generate_encdec`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..grid.datagrid import DataGridService
from ..models import model as M


@dataclasses.dataclass
class Request:
    request_id: int
    tokens: np.ndarray                  # prompt (S,)
    max_new_tokens: int = 16
    prefix_id: str | None = None        # shared-prefix KV artifact
    adapter_id: str | None = None       # LoRA artifact


class ServeEngine:
    """Single-model compute engine: prefill once, decode step by step.

    ``backend`` picks the attention and scan kernels' route (see
    :data:`repro_torch.kernels.flash_attention.BACKENDS`). ``last_timing``
    holds the wall seconds of the last :meth:`generate`'s prefill (up to
    the first token) and decode loop, each ended by a device
    synchronisation on a card."""

    def __init__(self, cfg: ArchConfig, params: dict, *, max_len: int = 512,
                 backend: str = "auto") -> None:
        if cfg.enc_dec:
            raise ValueError(
                f"ServeEngine serves token prompts; {cfg.name} is an "
                "encoder-decoder whose requests are frames: serve it through "
                "generate_encdec (model.prefill(frames=), model.decode_step)")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.backend = backend
        self.device = params["embed"].device
        self.last_timing: dict[str, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(self, tokens, n_new: int, *, return_logits: bool = False):
        """tokens: (B, S) prompt -> (B, n_new) greedy continuation (numpy
        int64). With ``return_logits`` also the (B, n_new, V) float32
        logits each emitted token was the argmax of (on the device)."""
        tokens = torch.as_tensor(np.asarray(tokens), device=self.device)
        B, S = tokens.shape
        if S + n_new > self.max_len:
            raise ValueError(f"prompt {S} + {n_new} new tokens > max_len "
                             f"{self.max_len}")
        cfg, params = self.cfg, self.params
        caches = M.init_caches(cfg, B, self.max_len, device=self.device,
                               dtype=params["embed"].dtype)
        t0 = time.perf_counter()
        logits, caches = M.prefill(cfg, params, tokens, caches=caches,
                                   backend=self.backend)
        toks, seen, self.last_timing = _greedy(
            logits, lambda tok, pos: M.decode_step(
                cfg, params, caches, tok, pos, backend=self.backend)[0],
            n_new, S, self._sync, t0)
        return (toks, seen) if return_logits else toks


def _greedy(logits: torch.Tensor, step, n_new: int, pos0: int, sync,
            t0: float):
    """The greedy loop after a prefill's ``logits``: token i is the argmax
    of the last logits, then ``step(token, pos0 + i)`` gives the next
    logits. Returns the tokens (B, n_new) numpy int64, the logits each was
    the argmax of (B, n_new, V) on the device, and the wall seconds of the
    prefill (from ``t0`` to the first token) and of the loop, each ended
    by ``sync()``."""
    tok = logits[:, -1:].argmax(-1)
    sync()
    t1 = time.perf_counter()
    out, seen = [], []
    for i in range(n_new):
        out.append(tok[:, 0])
        seen.append(logits[:, -1])
        logits = step(tok, pos0 + i)
        tok = logits[:, -1:].argmax(-1)
    sync()
    timing = {"prefill_s": t1 - t0, "decode_s": time.perf_counter() - t1}
    toks = (torch.stack(out, 1) if out else tok[:, :0]).cpu().numpy()
    return toks, (torch.stack(seen, 1) if seen else logits[:, :0]), timing


@torch.inference_mode()
def generate_encdec(cfg: ArchConfig, params: dict, frames, n_new: int, *,
                    backend: str = "auto") -> dict:
    """Greedy decoding of an encoder-decoder (whisper) from frame
    embeddings (B, S_enc, D): ``model.prefill`` (the encoder, the cross
    caches and the BOS step at position 0), then ``n_new`` decode steps at
    positions 1..n_new, the loop :meth:`ServeEngine.generate` runs. Returns
    ``tokens`` (B, n_new) numpy int64, the ``logits`` (B, n_new, V) each
    was the argmax of (on the device), and ``prefill_s`` / ``decode_s``
    (wall, each ended by a device synchronisation on a card)."""
    if not cfg.enc_dec:
        raise ValueError(f"{cfg.name} is not an encoder-decoder: serve it "
                         "through ServeEngine")
    dev = params["embed"].device
    frames = torch.as_tensor(frames, device=dev)
    B, S = frames.shape[:2]
    dec_len = max(1, S // M.DEC_RATIO)
    if n_new >= dec_len:
        raise ValueError(f"{n_new} new tokens need {n_new + 1} decoder "
                         f"positions; {S} frames give {dec_len}")
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    caches = M.init_caches(cfg, B, S, device=dev)
    t0 = time.perf_counter()
    logits, caches = M.prefill(cfg, params, caches=caches, frames=frames,
                               backend=backend)
    toks, seen, timing = _greedy(
        logits, lambda tok, pos: M.decode_step(
            cfg, params, caches, tok, pos, backend=backend)[0],
        n_new, 1, sync, t0)
    return {"tokens": toks, "logits": seen, **timing}


class GridRouter:
    """Routes requests across a pool of engine sites (paper §3.2)."""

    def __init__(self, grid: DataGridService, n_engines: int) -> None:
        self.grid = grid
        self.n_engines = n_engines
        self.routed: list[tuple[int, int]] = []     # (request_id, site)

    def register_prefix(self, prefix_id: str, kv_bytes: float,
                        master_site: int = 0) -> None:
        self.grid.register(prefix_id, kv_bytes, master_site)

    def route(self, req: Request) -> int:
        required = [a for a in (req.prefix_id, req.adapter_id) if a]
        site, _ = self.grid.place_job(required, length=float(len(req.tokens)))
        self.routed.append((req.request_id, site))
        return site

    def complete(self, site: int, req: Request) -> None:
        self.grid.complete_job(site, length=float(len(req.tokens)))


def greedy_agreement(tokens, ref_tokens, ref_logits: torch.Tensor, *,
                     atol: float, rtol: float) -> int:
    """Hold greedy tokens (B, n) to a reference route's tokens and the
    (B, n, V) logits they were the argmax of, when each logit may move by
    ``atol + rtol * |logit|``. A step whose reference top-2 margin exceeds
    twice that must give the same token; at a closer margin the routes may
    pick differently, and a row that does so is compared no further (its
    contexts differ from then on). Returns the number of tokens held;
    raises ``AssertionError`` at the first disagreement."""
    top2 = ref_logits.float().topk(2, dim=-1).values.cpu().numpy()
    margin = top2[..., 0] - top2[..., 1]
    allowed = 2 * (atol + rtol * np.abs(top2[..., 0]))
    tokens, ref_tokens = np.asarray(tokens), np.asarray(ref_tokens)
    held = 0
    for b in range(tokens.shape[0]):
        for i in range(tokens.shape[1]):
            if margin[b, i] > allowed[b, i]:
                if tokens[b, i] != ref_tokens[b, i]:
                    raise AssertionError(
                        f"row {b} step {i}: token {tokens[b, i]} != "
                        f"{ref_tokens[b, i]} at top-2 margin "
                        f"{margin[b, i]!r} > {allowed[b, i]!r}")
                held += 1
            elif tokens[b, i] != ref_tokens[b, i]:
                break
    return held
