"""GPT acoustic decoder (``UnifiedVoice``, gpt/model.py:265-545).

Counterpart of ``detail_tts_tpu/models/gpt.py``: a GPT-2 trunk (pre-LN,
gelu_new, learned per-modality positions, no global positions) over
[cond(1), text(T_text + 2), mel] embeddings, with

* ``decode_prefill``/``decode_step`` over a preallocated per-layer KV cache
  that is written in place, in JAX's cached formulation: the keys and
  values land at the cache's length, a device tensor, and the queries
  attend over the whole cache under the causal mask ``k_pos <= q_pos``, so
  every step of a decode has the same shapes and reads its position from
  the device;
* ``generate_speech_tokens``: a Python loop of cached steps that stops when
  every row has emitted the stop token (or after ``max_generate_length``),
  step s sampling with the Gumbel noise of JAX's key chain ``rng, key =
  split(rng)`` (``ops/prng.py``), each step's sampling and bookkeeping one
  ``ops/sampling.py`` ``sample_step`` (one kernel launch on CUDA), each
  step's GPT call one replay of a CUDA graph of the static step where the
  model is whole on a card (``DecodeSteps``), else the same step eagerly;
* ``forward``: the ``return_latent=True`` pass (latents of the mel positions,
  ``mel_latents[:, :-2]``) and the training pass, the text and mel heads'
  unmasked mean cross-entropies in fp32.

Dropout (``GPTConfig.dropout`` in the trunk, 0.1 in the conditioning
encoder) draws its masks from ``generator`` in ``train()`` mode: on the
embeddings, then in each block on the attention weights, the attention
output and the MLP output, as HF GPT-2 and the JAX module place it.

``remat`` (``TrainConfig.remat_gpt``, JAX's ``nn.remat`` over the blocks,
gpt.py:141-145): in a training forward (grad mode on, no cache) each block
runs under ``torch.utils.checkpoint`` and its activations are recomputed
in the backward.  The recompute replays the block's dropout masks: the
generator's state before the block is saved and set for the recompute,
and the generator's state at the recompute is restored after it, so the
gradient is the one of the forward's masks and the step's later draws are
untouched (``checkpoint`` itself replays torch's global generators only).

Tensor parallelism (``parallel.mesh.shard_module_`` over a mesh's model
group, Megatron's layout; JAX shards the same tensors by its
``PARTITION_RULES``): the attention's ``c_attn`` is column-parallel by head
(this rank's heads of q, k and v) and its ``c_proj`` row-parallel, the
sum over the model group taken *before* the bias is added; the MLP's
``c_fc`` column-parallel and ``c_proj`` row-parallel; ``mel_embedding``
vocab-parallel (a masked lookup of this rank's rows, then the sum); the
heads (where the vocab splits) give vocab-sharded logits, which the
training loss takes through a vocab-parallel cross-entropy and the decode
gathers whole (the warpers read the whole vocab).  The KV cache holds the
local heads.  Every activation outside the sharded heads is replicated on
the model peers, so they draw the same dropout masks from the same
generator; the attention-weight dropout draws the mask of every head and
keeps this rank's, so the step is the one-card step mask for mask.  The
recompute of ``remat`` re-runs the block's collectives.  A module whose
``tp`` is None runs exactly the one-card code.

Parameter names are the reference's (``gpt.gpt.h.0.attn.c_attn.weight``...);
HF GPT-2's ``Conv1D`` keeps its (in, out) weight layout.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import math
import threading
from typing import List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from detail_tts_tpu_torch import tracing
from detail_tts_tpu_torch.config import GPTConfig
from detail_tts_tpu_torch.nn.common import (Dense, SeededDropout, TorchLayerNorm,
                                            sequence_mask)
from detail_tts_tpu_torch.nn.style_encoder import MelStyleEncoder
from detail_tts_tpu_torch.ops import prng
from detail_tts_tpu_torch.ops.sampling import sample_step
from detail_tts_tpu_torch.parallel.mesh import (Rows, Shard, all_reduce_max_host,
                                                copy_to_model, gather_from_model,
                                                reduce_from_model,
                                                vocab_parallel_cross_entropy)


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """HF 'gelu_new' tanh approximation."""
    return 0.5 * x * (1.0 + torch.tanh(
        0.7978845608028654 * (x + 0.044715 * torch.pow(x, 3.0))))


class Conv1D(nn.Module):
    """HF GPT-2 ``Conv1D``: y = x @ weight + bias, weight (in, out)."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out))
        self.bias = nn.Parameter(torch.zeros(n_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype).t(), self.bias.to(x.dtype))


@dataclasses.dataclass
class KVCache:
    """Per-layer (B, max_len, H, ch) keys and values; ``length`` valid rows,
    a 0-dim int64 tensor on the cache's device."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    length: torch.Tensor


def _row_parallel(proj: Conv1D, x: torch.Tensor, tp: Optional[Shard]) -> torch.Tensor:
    """``proj(x)`` of a row-parallel projection: this rank's rows of the
    weight, the sum over the model group, then the (replicated) bias."""
    if tp is None:
        return proj(x)
    y = reduce_from_model(F.linear(x, proj.weight.to(x.dtype).t()), tp)
    return y + proj.bias.to(y.dtype)


class GPT2Attention(nn.Module):
    tp: Optional[Shard] = None  # the model group, set by shard_module_

    def __init__(self, dim: int, heads: int, dropout: float = 0.0):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.c_attn = Conv1D(dim, 3 * dim)
        self.c_proj = Conv1D(dim, dim)
        self.attn_dropout = SeededDropout(dropout)
        self.resid_dropout = SeededDropout(dropout)

    def forward(self, x: torch.Tensor,
                cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                start: Union[int, torch.Tensor] = 0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Causal self-attention.  With a cache, ``start`` is its length, a
        0-dim device tensor: x's keys land at [start, start + T) by
        ``index_copy_`` and the queries attend over the whole cache, masked
        past their own positions, as JAX's cached attention does, so no
        shape depends on ``start``."""
        b, t, _ = x.shape
        tp = self.tp
        ch = self.dim // self.heads
        h = self.heads if tp is None else self.heads // tp.size  # this rank's heads
        q, k, v = self.c_attn(copy_to_model(x, tp)).reshape(b, t, 3, h, ch).unbind(2)
        q_pos = start + torch.arange(t, device=x.device)
        if cache_kv is not None:
            k_cache, v_cache = cache_kv
            k_cache.index_copy_(1, q_pos, k.to(k_cache.dtype))
            v_cache.index_copy_(1, q_pos, v.to(v_cache.dtype))
            k, v = k_cache.to(x.dtype), v_cache.to(x.dtype)
        logits = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(ch)
        k_pos = torch.arange(k.shape[1], device=x.device)
        causal = k_pos[None, :] <= q_pos[:, None]
        logits = logits.masked_fill(~causal, -1e9)
        w = self.attn_dropout(torch.softmax(logits, dim=-1).to(x.dtype), generator,
                              None if tp is None else (1, tp.rank, tp.size))
        out = torch.einsum("bhts,bshd->bthd", w, v).reshape(b, t, h * ch)
        return self.resid_dropout(_row_parallel(self.c_proj, out, tp), generator)


class GPT2MLP(nn.Module):
    tp: Optional[Shard] = None  # the model group, set by shard_module_

    def __init__(self, dim: int, dropout: float = 0.0):
        super().__init__()
        self.c_fc = Conv1D(dim, 4 * dim)
        self.c_proj = Conv1D(4 * dim, dim)
        self.dropout = SeededDropout(dropout)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = gelu_new(self.c_fc(copy_to_model(x, self.tp)))
        return self.dropout(_row_parallel(self.c_proj, h, self.tp), generator)


class GPT2Block(nn.Module):
    def __init__(self, dim: int, heads: int, eps: float, dropout: float = 0.0):
        super().__init__()
        self.ln_1 = TorchLayerNorm(dim, eps=eps)
        self.attn = GPT2Attention(dim, heads, dropout)
        self.ln_2 = TorchLayerNorm(dim, eps=eps)
        self.mlp = GPT2MLP(dim, dropout)

    def forward(self, x, cache_kv=None, start: Union[int, torch.Tensor] = 0, generator=None):
        x = x + self.attn(self.ln_1(x), cache_kv, start, generator)
        return x + self.mlp(self.ln_2(x), generator)


@contextlib.contextmanager
def _replay(generator: torch.Generator, state: torch.Tensor):
    """``generator`` at ``state`` inside the block, at its own state after."""
    now = generator.get_state()
    generator.set_state(state)
    try:
        yield
    finally:
        generator.set_state(now)


def _remat_block(block: nn.Module, x: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """``block(x)`` whose activations are recomputed in the backward, with
    the forward's dropout masks."""
    if generator is None:
        return checkpoint(block, x, use_reentrant=False, preserve_rng_state=False)
    state = generator.get_state()
    # the block draws from ``generator`` only, so torch's global generators
    # need no replay
    return checkpoint(block, x, None, 0, generator, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _replay(generator, state)))


class GPT2Stack(nn.Module):
    """GPT-2 trunk over input embeddings (no wte/wpe)."""

    def __init__(self, layers: int, dim: int, heads: int, eps: float,
                 dropout: float = 0.0, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.drop = SeededDropout(dropout)
        self.h = nn.ModuleList([GPT2Block(dim, heads, eps, dropout)
                                for _ in range(layers)])
        self.ln_f = TorchLayerNorm(dim, eps=eps)

    def forward(self, emb: torch.Tensor, cache: Optional[KVCache] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.drop(emb, generator)
        remat = self.remat and cache is None and torch.is_grad_enabled()
        for i, block in enumerate(self.h):
            if remat:
                x = _remat_block(block, x, generator)
                continue
            kv = None if cache is None else (cache.k[i], cache.v[i])
            x = block(x, kv, 0 if cache is None else cache.length, generator)
        if cache is not None:
            cache.length += emb.shape[1]
        return self.ln_f(x)


class LearnedPositionEmbeddings(nn.Module):
    def __init__(self, seq_len: int, dim: int):
        super().__init__()
        self.emb = nn.Embedding(seq_len, dim)

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        return self.emb(positions)


class UnifiedVoice(nn.Module):
    tp: Optional[Shard] = None  # the model group, set by shard_module_

    def __init__(self, cfg: GPTConfig, remat: bool = False):
        super().__init__()
        c = self.cfg = cfg
        self.conditioning_encoder = MelStyleEncoder(
            c.spec_channels, style_hidden=c.model_dim // 2,
            style_vector_dim=c.model_dim)
        self.text_embedding = nn.Embedding(c.number_text_tokens + 1, c.model_dim)
        self.mel_embedding = nn.Embedding(c.number_mel_codes, c.model_dim)
        self.mel_pos_embedding = LearnedPositionEmbeddings(
            c.max_mel_tokens + 2 + c.max_conditioning_inputs, c.model_dim)
        self.text_pos_embedding = LearnedPositionEmbeddings(
            c.max_text_tokens + 2, c.model_dim)
        self.gpt = GPT2Stack(c.layers, c.model_dim, c.heads, c.layer_norm_eps,
                             c.dropout, remat)
        self.final_norm = TorchLayerNorm(c.model_dim, eps=c.layer_norm_eps)
        self.mel_head = Dense(c.model_dim, c.number_mel_codes)
        self.text_head = Dense(c.model_dim, c.number_text_tokens + 1)
        self.decode_steps = DecodeSteps()

    def _condition(self, cond_mel, cond_lengths, generator=None) -> torch.Tensor:
        mask = sequence_mask(cond_lengths, cond_mel.shape[1])
        return self.conditioning_encoder(cond_mel, mask, generator)[:, None, :]

    def _text_embeddings(self, text: torch.Tensor) -> torch.Tensor:
        """[start, text..., stop, stop] embeddings (stop-padded, aligned)."""
        c = self.cfg
        inp = F.pad(F.pad(text, (0, 1), value=c.stop_text_token), (1, 0),
                    value=c.start_text_token)
        pos = torch.arange(inp.shape[1], device=text.device)
        return self.text_embedding(inp) + self.text_pos_embedding(pos)

    def _vocab_tp(self, weight: torch.Tensor, width: int) -> Optional[Shard]:
        """The model group where ``weight``'s vocab rows are this rank's
        slice of ``width``; None where they are whole (no mesh, or demoted)."""
        return None if self.tp is None or weight.shape[0] == width else self.tp

    def _mel_embeddings(self, codes: torch.Tensor, positions) -> torch.Tensor:
        w = self.mel_embedding.weight
        tp = self._vocab_tp(w, self.cfg.number_mel_codes)
        if tp is None:
            emb = self.mel_embedding(codes)
        else:  # vocab-parallel: this rank's rows, zeros elsewhere, summed
            v = w.shape[0]
            local = codes - tp.rank * v
            mine = (local >= 0) & (local < v)
            emb = reduce_from_model(F.embedding(local.clamp(0, v - 1), w)
                                    * mine[..., None].to(w.dtype), tp)
        return emb + self.mel_pos_embedding(positions)

    def _head(self, head: nn.Module, x: torch.Tensor, width: int):
        """(logits, model group): the head's logits, vocab-sharded when its
        rows are (the group is then returned, else None)."""
        tp = self._vocab_tp(head.weight, width)
        return head(copy_to_model(x, tp)), tp

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """The mel head's full-vocab logits (gathered over the model group)."""
        logits, tp = self._head(self.mel_head, x, self.cfg.number_mel_codes)
        return gather_from_model(logits, tp)

    def forward(self, cond_mel, cond_lengths, text, mel_codes, wav_lengths,
                return_latent: bool = True,
                generator: Optional[torch.Generator] = None):
        """The training forward (gpt/model.py:429-491), text first.

        Codes past ``wav_lengths // mel_length_compression + 1`` become stop
        tokens.  ``return_latent``: the mel-position latents without the last
        two, (B, T_code, D); else ``(loss_text, loss_mel)``, each head's mean
        cross-entropy against its inputs shifted by one (stop-padded).
        """
        c = self.cfg
        mel_lengths = wav_lengths // c.mel_length_compression
        pos = torch.arange(mel_codes.shape[1], device=mel_codes.device)
        codes = torch.where(pos[None, :] < mel_lengths[:, None] + 1,
                            mel_codes, c.stop_mel_token)
        codes = F.pad(codes, (0, 1), value=c.stop_mel_token)
        mel_inp = F.pad(codes, (1, 0), value=c.start_mel_token)
        text_emb = self._text_embeddings(text)
        mel_emb = self._mel_embeddings(
            mel_inp, torch.arange(mel_inp.shape[1], device=codes.device))
        cond = self._condition(cond_mel, cond_lengths, generator).to(text_emb.dtype)
        hidden = self.gpt(torch.cat([cond, text_emb, mel_emb], dim=1),
                          generator=generator)
        enc = self.final_norm(hidden[:, 1:])
        mel_latents = enc[:, -mel_emb.shape[1]:]
        if return_latent:
            return mel_latents[:, :-2]
        text_tar = F.pad(F.pad(text, (0, 1), value=c.stop_text_token), (0, 1),
                         value=c.stop_text_token)
        mel_tar = F.pad(codes, (0, 1), value=c.stop_mel_token)
        return (_mean_ce(*self._head(self.text_head, enc[:, :text_emb.shape[1]],
                                     c.number_text_tokens + 1), text_tar),
                _mean_ce(*self._head(self.mel_head, mel_latents, c.number_mel_codes),
                         mel_tar))

    def prefill_embeddings(self, cond_mel, cond_lengths, text) -> torch.Tensor:
        """[cond, text_emb, start_mel_emb] prefix (gpt/model.py:514-530)."""
        text_emb = self._text_embeddings(text)
        start = torch.full((text.shape[0], 1), self.cfg.start_mel_token,
                           dtype=torch.long, device=text.device)
        start_emb = self._mel_embeddings(start, torch.zeros(
            1, dtype=torch.long, device=text.device))
        cond = self._condition(cond_mel, cond_lengths).to(text_emb.dtype)
        return torch.cat([cond, text_emb, start_emb], dim=1)

    def init_cache(self, batch: int, max_len: int, dtype, device) -> KVCache:
        """Per-layer (B, max_len, H, ch) keys and values, H this rank's
        heads, at length 0."""
        c = self.cfg
        heads = c.heads if self.tp is None else c.heads // self.tp.size
        shape = (batch, max_len, heads, c.model_dim // c.heads)
        return KVCache([torch.zeros(shape, dtype=dtype, device=device)
                        for _ in range(c.layers)],
                       [torch.zeros(shape, dtype=dtype, device=device)
                        for _ in range(c.layers)],
                       torch.zeros((), dtype=torch.long, device=device))

    def decode_prefill(self, emb: torch.Tensor, cache: KVCache) -> torch.Tensor:
        """Fill the cache with the prefix from position 0, zeroed first: a
        kept cache holds an earlier decode's keys and values past the
        prefix, and the mask gives them exact zero weight only if they are
        finite.  Mel logits at the prefix's last position.

        The prefix attends over the cache's first T rows, a view of it: over
        the whole cache its bf16 logits on an H100 rounded otherwise at 2
        rows than at 4 (a data rank's rows against one card's batch), over
        its own rows they do not."""
        cache.length.zero_()
        for x in cache.k + cache.v:
            x.zero_()
        t = emb.shape[1]
        prefix = KVCache([x[:, :t] for x in cache.k], [x[:, :t] for x in cache.v],
                         cache.length)
        hidden = self.gpt(emb, prefix)
        return self._logits(self.final_norm(hidden[:, -1]))

    def decode_step(self, token: torch.Tensor, position: torch.Tensor,
                    cache: KVCache) -> torch.Tensor:
        """One static cached step: token (B,), mel position (B,) -> logits
        (B, V).  The keys land at the cache's device length, the query
        attends over the whole cache masked past it, and the length moves on
        by one: no shape and no host value depends on the position."""
        emb = self._mel_embeddings(token[:, None], position[:, None])
        hidden = self.gpt(emb, cache)
        return self._logits(self.final_norm(hidden[:, -1]))


# static steps (each with its KV cache and, on a card, its graph) kept a
# model, the least recently used dropped first.  Each (batch size, text
# bucket) a server meets makes one; a kept step costs its cache, B x L x 30
# KiB at Config() (329 MiB at 8 rows of the largest text bucket), and a new
# one a capture, ~50 ms of host on an H100 (scripts/mixed_shape_serving.py:
# 9 shapes in 16 batches recaptured 11 times with 4 kept, 2-3% of the
# pass's wall against keeping all)
KEPT_STEPS = 16
# eager steps on a side stream before a capture, as CUDA graphs need
WARMUP_STEPS = 3


def _replays(model: UnifiedVoice, device: torch.device) -> bool:
    """A decode of ``model`` on ``device`` replays a CUDA graph: on a card,
    with the model whole there (no model group, whose step holds
    collectives)."""
    return device.type == "cuda" and model.tp is None


class _Step:
    """The static decode step at one shape: its token and mel-position
    inputs, its KV cache with the cache's device length, its logits, and on
    a card the CUDA graph that replays it."""

    def __init__(self, model: UnifiedVoice, batch: int, max_len: int, cache_dtype,
                 device: torch.device):
        self.token = torch.zeros(batch, dtype=torch.long, device=device)
        self.position = torch.zeros(batch, dtype=torch.long, device=device)
        self.cache = model.init_cache(batch, max_len, cache_dtype, device)
        self.logits: Optional[torch.Tensor] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def run(self, model: UnifiedVoice) -> None:
        """The step eagerly: ``logits`` of ``token`` at ``position``; the
        cache's length and the position move on by one."""
        self.logits = model.decode_step(self.token, self.position, self.cache)
        self.position += 1

    def capture(self, model: UnifiedVoice, pool) -> None:
        """Capture ``run`` as a graph in ``pool`` on a side stream, after
        ``WARMUP_STEPS`` eager steps there; they write the cache from
        position 0, which the next prefill zeroes.  The capture is begun
        and ended by hand: ``torch.cuda.graph`` would first synchronise the
        device, waiting for the batch in flight, and empty the allocator's
        cache, which the next batch would then allocate anew."""
        device = self.token.device
        with torch.cuda.device(device):
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    self.run(model)
                self.graph = torch.cuda.CUDAGraph()
                self.graph.capture_begin(pool, capture_error_mode="thread_local")
                try:
                    self.run(model)
                finally:
                    self.graph.capture_end()
            torch.cuda.current_stream(device).wait_stream(side)
        tracing.count("decode.graph_captures")

    def prefill(self, model: UnifiedVoice, emb: torch.Tensor) -> torch.Tensor:
        """The prefix into the cache (eagerly, from position 0) and the mel
        position to 1; the logits at the prefix's last position."""
        self.position.fill_(1)
        return model.decode_prefill(emb, self.cache)

    def step(self, model: UnifiedVoice, token: torch.Tensor) -> torch.Tensor:
        """``token`` into the static input (one device copy), then the step:
        a replay of the graph, else eagerly.  The logits are overwritten by
        the next step, and by a replay of another of the model's graphs,
        whose memory pool they share."""
        self.token.copy_(token)
        if self.graph is None:
            self.run(model)
        else:
            self.graph.replay()
            tracing.count("decode.graph_replays")
        return self.logits


class DecodeSteps:
    """A model's static decode steps, one a (batch, cache length, cache
    dtype, compute dtype, device), the ``KEPT_STEPS`` used last kept with
    their KV caches, which each prefill zeroes.  Where ``_replays``, each
    step is captured once as a CUDA graph, all of a model's graphs in one
    memory pool; a graph reads the weights where they lay at its capture, so
    the steps are dropped when a parameter or buffer of the model moves.

    The state is the model's: one decode at a time holds ``lock`` (the
    engine decodes from the thread that calls it; ``TTSServer`` from its one
    dispatch thread); a copy of the model starts with none."""

    def __init__(self):
        self.lock = threading.Lock()
        self._steps: "collections.OrderedDict[tuple, _Step]" = collections.OrderedDict()
        self._weights: Optional[Tuple[int, ...]] = None
        self._pool = None

    def __reduce__(self):
        """A copy of the model (``deepcopy``, pickling) starts with none."""
        return DecodeSteps, ()

    def get(self, model: UnifiedVoice, batch: int, max_len: int, cache_dtype,
            device: torch.device) -> _Step:
        """The step at this shape, made (and on a card captured) at its
        first use, before its first prefill."""
        weights = tuple(t.data_ptr() for t in itertools.chain(model.parameters(),
                                                              model.buffers()))
        if weights != self._weights:
            self._steps.clear()
            self._weights = weights
        key = (batch, max_len, cache_dtype, model.mel_embedding.weight.dtype, device)
        step = self._steps.get(key)
        if step is not None:
            self._steps.move_to_end(key)
            return step
        while len(self._steps) >= KEPT_STEPS:
            self._steps.popitem(last=False)
        step = _Step(model, batch, max_len, cache_dtype, device)
        if _replays(model, device):
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            step.capture(model, self._pool)
        self._steps[key] = step
        return step


def _mean_ce(logits: torch.Tensor, tp: Optional[Shard],
             targets: torch.Tensor) -> torch.Tensor:
    """Unmasked mean cross-entropy in fp32 (the reference's plain
    ``F.cross_entropy``: padding is stop-token supervised by construction);
    vocab-parallel over ``tp`` where the logits are this rank's columns."""
    logits = logits.float().flatten(0, -2)
    if tp is None:
        return F.cross_entropy(logits, targets.flatten())
    return vocab_parallel_cross_entropy(logits, targets.flatten(), tp)


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.8
    top_p: float = 0.8
    repetition_penalty: float = 2.0
    max_generate_length: int = 600
    typical_mass: float = 1.0
    # ignore stop tokens and always decode max_generate_length steps
    force_full_length: bool = False


@torch.inference_mode()
def generate_speech_tokens(model: UnifiedVoice, cond_mel, cond_lengths, text,
                           sampling: SamplingConfig = SamplingConfig(),
                           key: prng.Seed = 0,
                           cache_dtype=torch.bfloat16, rows: Optional[Rows] = None,
                           group=None):
    """AR decode with a KV cache.

    Returns (codes (B, max_len) padded with stop tokens, lengths (B,)), where
    ``lengths`` counts generated tokens including the stop token.  Step s
    is one ``sample_step`` (the warpers, the Gumbel draw under the s-th key
    of JAX's chain from ``key``, the argmax and ``body_fn``'s bookkeeping,
    in place): the chain ``rng, key = split(rng)`` a step is written to a
    device buffer in one launch before the loop, and a step reads its row
    there.  Its token goes into the model's static step at this shape
    (``model.decode_steps``), whose GPT call is one replay of a CUDA graph
    where ``_replays`` (counter ``decode.graph_replays``; a capture, at the
    first decode at a shape, counts under ``decode.graph_captures``) and
    the same step eagerly elsewhere.  On a data rank of a sharded engine the
    batch is this rank's ``rows`` of the request, whose elements of each
    step's draw it takes (from their offset), and the early stop waits for
    every row of ``group`` (the data group), so the decode ends as on one
    card; the early stop runs between steps, outside the graph.  Each step
    is a ``decode_step`` span (children ``sample`` and ``gpt``; under a
    replay ``gpt`` is the host's enqueue of one graph launch) and counts
    under ``decode.steps``.
    """
    c = model.cfg
    b = text.shape[0]
    n = sampling.max_generate_length
    dev = text.device
    prefill = model.prefill_embeddings(cond_mel, cond_lengths, text)
    with model.decode_steps.lock:
        steps = model.decode_steps.get(model, b, prefill.shape[1] + n, cache_dtype, dev)
        logits = steps.prefill(model, prefill)

        # the repetition penalty covers the fake prefix: filler id 1 + start
        seen = torch.zeros((b, c.number_mel_codes), dtype=torch.bool, device=dev)
        seen[:, 1] = True
        seen[:, c.start_mel_token] = True
        codes = torch.full((b, n), c.stop_mel_token, dtype=torch.long, device=dev)
        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        lengths = torch.zeros(b, dtype=torch.long, device=dev)
        keys = prng.decode_keys(key, n, dev)
        offset = prng.row_offset(rows, (b, c.number_mel_codes))
        for step in range(n):
            if not sampling.force_full_length and step and _all_finished(finished, group):
                break
            with tracing.span("decode_step"):
                with tracing.span("sample"):
                    tok = sample_step(logits, seen, codes, lengths, finished, step,
                                      keys[step], temperature=sampling.temperature,
                                      top_p=sampling.top_p,
                                      repetition_penalty=sampling.repetition_penalty,
                                      typical_mass=sampling.typical_mass,
                                      stop_token=c.stop_mel_token,
                                      force_full=sampling.force_full_length, offset=offset)
                if step + 1 < n:
                    with tracing.span("gpt"):
                        logits = steps.step(model, tok)
            tracing.count("decode.steps")
    return codes, lengths


def _all_finished(finished: torch.Tensor, group=None) -> bool:
    """Every row has stopped: this rank's (a host synchronisation), and with
    a group every rank's (one small all-reduce)."""
    with tracing.wait("finished"):
        done = bool(finished.all())
    if group is None:
        return done
    return not all_reduce_max_host([int(not done)], group)[0]
