"""Data-parallel runs for the port's tests: world-W gloo process groups on
the CPU, started with ``torch.multiprocessing`` (spawn) on a ``file://``
store, and the training-step worker they run.

Kept apart from the test modules so that a spawned rank imports torch and
the port only, not JAX.  A rank's failure raises in the parent.
"""
from __future__ import annotations

import copy
import itertools
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn
from detail_tts_tpu_torch.nn.common import SeededDropout, weight_norm_
from detail_tts_tpu_torch.parallel import mesh
from detail_tts_tpu_torch.train.step import GAN_TARGETS, make_train_state, make_train_step

_runs = itertools.count()
DEADLINE_S = 600.0  # a spawn that outlives it is a hang: its ranks are killed


def spawn(fn: Callable, world: int, tmp_path, *args,
          deadline: float = DEADLINE_S) -> List[object]:
    """``fn(group, *args)`` on ranks 0..world-1, one process each; returns
    each rank's result in rank order.  Raises ``TimeoutError``, after
    killing the ranks, if they have not all returned within ``deadline``
    seconds."""
    path = Path(tmp_path) / f"dist{os.getpid()}_{next(_runs)}"
    path.mkdir(parents=True)
    ctx = mp.start_processes(_entry, args=(fn, world, str(path), args), nprocs=world,
                             join=False, start_method="spawn")
    end = time.monotonic() + deadline
    while not ctx.join(timeout=max(end - time.monotonic(), 0.0)):
        if time.monotonic() >= end:
            for p in ctx.processes:
                p.kill()
                p.join()
            raise TimeoutError(f"{fn.__name__} on {world} ranks outlived its "
                               f"deadline of {deadline:g} s")
    return [torch.load(path / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _entry(rank: int, fn: Callable, world: int, path: str, args) -> None:
    torch.set_num_threads(1)
    group, _ = mesh.init_distributed(f"file://{path}/store", device="cpu", rank=rank,
                                     world_size=world)
    try:
        torch.save(fn(group, *args), f"{path}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def build_state(cfg, model_sd, disc=None, no_dropout=True, mesh_=None):
    """A training state on the CPU from a model state dict (weight-normed
    under ``cfg.train.weight_norm``) and, for the GAN targets, a
    discriminator module; every dropout at p = 0 when ``no_dropout``;
    sharded over ``mesh_``'s model group when given."""
    model = SynthesizerTrn(cfg)
    if cfg.train.weight_norm:
        weight_norm_(model)
    model.load_state_dict(model_sd)
    if no_dropout:
        for m in model.modules():
            if isinstance(m, SeededDropout):
                m.p = 0.0
    return make_train_state(cfg, device="cpu", model=model,
                            disc=None if disc is None else copy.deepcopy(disc), mesh=mesh_)


def moments(optimizer, module) -> Dict[str, torch.Tensor]:
    """AdamW's first moments keyed by ``module``'s parameter names."""
    names = {id(p): n for n, p in module.named_parameters()}
    return {names[id(p)]: s["exp_avg"].clone() for p, s in optimizer.state.items()}


def train_steps(group, cfg, model_sd, batches: Sequence[Dict[str, torch.Tensor]],
                draws: Optional[Sequence] = None, disc=None, seed: int = 0,
                no_dropout: bool = True, all_reduce: bool = True) -> dict:
    """One step a batch of ``batches`` (global batches, this rank takes
    its rows) from the same initial state on every rank; ``draws``: the
    global draws of each step, else the step draws from a generator seeded
    ``seed + k``.  ``all_reduce=False`` drops the gradient all-reduce (a
    negative control).  Returns the metrics of each step, the model (and
    discriminator) state and the AdamW first moments after the last."""
    state = build_state(cfg, model_sd, disc, no_dropout)
    if not all_reduce:  # this process only: a spawned rank
        mesh.all_reduce_grads = lambda params, group=None: None
    step = make_train_step(cfg, "cpu", group)
    axis = 0 if cfg.train.target in GAN_TARGETS else 1
    drop_gen = (mesh.rank_generator(seed, "cpu", group) if mesh.world(group) > 1
                else None)
    metrics = []
    for k, batch in enumerate(batches):
        m = step(state, mesh.shard_batch(batch, group, axis),
                 torch.Generator().manual_seed(seed + k),
                 draws=None if draws is None else draws[k], dropout_generator=drop_gen)
        metrics.append({n: v.clone() for n, v in m.items() if torch.is_tensor(v)})
    out = {"metrics": metrics, "model": copy.deepcopy(state.model.state_dict()),
           "moments": moments(state.optimizer, state.model)}
    if state.disc is not None:
        out["disc"] = copy.deepcopy(state.disc.state_dict())
        out["d_moments"] = moments(state.d_optimizer, state.disc)
    return out


def codebook_call(group, buffers: Dict[str, torch.Tensor], x: torch.Tensor,
                  kmeans: torch.Tensor, expire: torch.Tensor, codebook: Dict) -> dict:
    """One training call of an ``EuclideanCodebook(**codebook)`` holding
    ``buffers`` on this rank's rows of the global vectors ``x`` (N, D),
    with global draws; returns its buffers and ids after."""
    from detail_tts_tpu_torch.models.quantizer import EuclideanCodebook

    cb = EuclideanCodebook(buffers["embed"].shape[0], buffers["embed"].shape[1], **codebook)
    cb.load_state_dict(buffers)
    _, ids = cb(mesh.shard_rows(x, group), kmeans, expire, group)
    return {"ids": ids, **{k: v.clone() for k, v in cb.state_dict().items()}}


def kl_call(group, tensors: Sequence[torch.Tensor], mask: torch.Tensor) -> dict:
    """``kl_loss`` on this rank's rows with the group (the global ratio's
    share) and without (a per-rank ratio), and the gradient of each with
    respect to this rank's ``z_p`` rows."""
    from detail_tts_tpu_torch.train.losses import kl_loss

    out = {}
    for name, g in (("global", group), ("per_rank", None)):
        z_p, logs_q, m_p, logs_p = (mesh.shard_rows(x, group).clone().requires_grad_(i == 0)
                                    for i, x in enumerate(tensors))
        loss = kl_loss(z_p, logs_q, m_p, logs_p, mesh.shard_rows(mask, group), g)
        loss.backward()
        out[name] = (loss.detach(), z_p.grad)
    return out


def loader_and_metrics_call(group, batches: Sequence[Dict], hop: int) -> dict:
    """Rank r's loader batch ``batches[r]`` padded to the ranks' agreed
    lengths, the step's metric reduction and the gradient all-reduce with a
    missing gradient, on values that differ by rank."""
    from detail_tts_tpu_torch.data.dataset import pad_to_agreed

    r = mesh.rank(group)
    batch = batches[r]
    params = [torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(2, 2))]
    params[0].grad = torch.full((3,), float(r + 1))  # params[1] has no gradient
    mesh.all_reduce_grads(params, group)
    metrics = mesh.reduce_metrics({"loss": torch.tensor(float(r)), "grad_norm":
                                   torch.tensor(float(r)), "layers_kept": [r]},
                                  ["loss"], group)
    return {"batch": pad_to_agreed(batch, hop, group), "grads": [p.grad for p in params],
            "metrics": metrics}


def dropout_call(group, cfg, model_sd, batch: Dict[str, torch.Tensor]) -> dict:
    """At the config's dropout: this rank's loss of its rows through the
    GPT with its own dropout generator (before any reduction), and a
    repeated world-W step from the same state and generator states."""
    state = build_state(cfg, model_sd, no_dropout=False)
    step = make_train_step(cfg, "cpu", group)
    local = mesh.shard_batch(batch, group, 1)
    with torch.no_grad():
        loss = state.model.forward_gpt({k: v[0] for k, v in local.items()},
                                       mesh.rank_generator(3, "cpu", group))
    drop_gen = mesh.rank_generator(3, "cpu", group)
    snap, d_state = state.snapshot(), drop_gen.get_state()
    runs = []
    for _ in range(2):
        state.restore(snap)
        drop_gen.set_state(d_state)
        m = step(state, local, torch.Generator().manual_seed(4), dropout_generator=drop_gen)
        runs.append(({k: v for k, v in m.items() if torch.is_tensor(v)},
                     copy.deepcopy(state.model.state_dict()), drop_gen.get_state()))
    return {"local_loss": loss, "runs": runs}


def resume_call(group, cfg, batches: Sequence[Dict[str, torch.Tensor]], logs: str) -> dict:
    """Trainer A takes two steps (a checkpoint at 2), then step 3; trainer R,
    built from another seed, restores A's checkpoint and takes step 3 on
    the same batch.  Returns both step-3 results and whether ``batch_size``
    that the world does not divide is refused."""
    import dataclasses

    from detail_tts_tpu_torch.train.checkpoint import optimizer_state_by_name
    from detail_tts_tpu_torch.train.trainer import Trainer

    def local(it):
        return (mesh.shard_batch(b, group, 1) for b in it)

    out = {}
    for name, seed, data in (("a", 0, batches), ("r", 7, batches[2:])):
        tr = Trainer(cfg, local(data), device="cpu", seed=seed, logs_folder=logs, group=group)
        if name == "r":
            tr.load(f"{logs}/ckpt")
            assert tr.state.step == 2
        tr.train(max_steps=3, log_every=1)
        out[name] = (tr.last_metrics["loss"], copy.deepcopy(tr.state.model.state_dict()),
                     optimizer_state_by_name(tr.state.optimizer, tr.state.model))
        tr.close()
    odd = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=3))
    try:
        Trainer(odd, device="cpu", logs_folder=logs + "/odd", group=group).default_data(
            "unread.jsonl")
        out["odd_refused"] = False
    except ValueError:
        out["odd_refused"] = True
    return out


def run_cli_as_torchrun(world: int, tmp_path, argv: Sequence[str]) -> List[dict]:
    """``python -m detail_tts_tpu_torch.train argv`` on ``world`` ranks
    that see the environment torchrun sets (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); returns each rank's
    last logged scalars."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    path = Path(tmp_path) / f"cli{os.getpid()}_{next(_runs)}"
    path.mkdir(parents=True)
    mp.start_processes(_cli_rank, args=(world, port, list(argv), str(path)), nprocs=world,
                       join=True, start_method="spawn")
    return [torch.load(path / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _cli_rank(rank: int, world: int, port: int, argv: List[str], path: str) -> None:
    from detail_tts_tpu_torch.train import __main__ as train_cli

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.save(train_cli.main(argv), f"{path}/rank{rank}.pt")


def tp_train_steps(group, cfg, model_sd, batches: Sequence[Dict[str, torch.Tensor]],
                   draws: Optional[Sequence] = None, norm_all_reduce: bool = True,
                   step_group: str = "data") -> dict:
    """:func:`train_steps` on the (``cfg.mesh``) mesh of ``group``'s ranks,
    dropout 0: the GPT sharded over the model group, this data rank's rows.
    Returns the metrics, the gathered state dict and AdamW first moments,
    and each replicated tensor of this rank.  Negative controls:
    ``norm_all_reduce=False`` drops the model-group sum of the grad norm;
    ``step_group="world"`` runs the step's collectives (the quantizer's
    among them) over every rank instead of the data group."""
    from detail_tts_tpu_torch.train import optim
    from detail_tts_tpu_torch.train.checkpoint import optimizer_state_by_name

    m = mesh.make_mesh(cfg.mesh.data_parallel, cfg.mesh.model_parallel, group)
    if not norm_all_reduce:  # this process only: a spawned rank
        optim._model_sum = lambda x, group: x
    state = build_state(cfg, model_sd, mesh_=m)
    over = group if step_group == "world" else m.data_group
    step = make_train_step(cfg, "cpu", over)
    drop_gen = mesh.rank_generator(0, "cpu", over) if mesh.world(over) > 1 else None
    axis = 0 if cfg.train.target in GAN_TARGETS else 1
    metrics = []
    for k, batch in enumerate(batches):
        out = step(state, mesh.shard_batch(batch, m.data_group, axis),
                   torch.Generator().manual_seed(k), draws=None if draws is None else draws[k],
                   dropout_generator=drop_gen)
        metrics.append({n: v.clone() for n, v in out.items() if torch.is_tensor(v)})
    moments = optimizer_state_by_name(state.optimizer, state.model, gather=True)
    return {"metrics": metrics, "model": mesh.gather_state_dict(state.model),
            "moments": {n: s["exp_avg"] for n, s in moments.items()},
            "replicated": {n: v.clone() for n, v in state.model.state_dict().items()
                           if n not in mesh.model_shards(state.model)}}


def tp_checkpoint_call(group, cfg, model_sd, batch, save_dir: Optional[str],
                       restore_dir: Optional[str]) -> dict:
    """On the (``cfg.mesh``) mesh, dropout 0: restore ``restore_dir`` (else
    start from ``model_sd``), take one step on ``batch``, save into
    ``save_dir`` when given.  Returns the gathered state after the restore
    and after the step, the step's metrics and the gathered moments."""
    from detail_tts_tpu_torch.train import checkpoint as ckpt

    m = mesh.make_mesh(cfg.mesh.data_parallel, cfg.mesh.model_parallel, group)
    state = build_state(cfg, model_sd, mesh_=m)
    if restore_dir is not None:
        ckpt.restore_checkpoint(restore_dir, state, partial=False, verbose=False)
    restored = ({k: v.clone() for k, v in mesh.gather_state_dict(state.model).items()},
                ckpt.optimizer_state_by_name(state.optimizer, state.model, gather=True))
    step = make_train_step(cfg, "cpu", m.data_group)
    metrics = step(state, mesh.shard_batch(batch, m.data_group, 1),
                   torch.Generator().manual_seed(0))
    if save_dir is not None:
        ckpt.save_checkpoint(save_dir, state, mesh=m)
    return {"restored": restored, "metrics": {n: v for n, v in metrics.items()
                                              if torch.is_tensor(v)},
            "model": mesh.gather_state_dict(state.model),
            "moments": ckpt.optimizer_state_by_name(state.optimizer, state.model,
                                                    gather=True)}


def tp_eval_dump(group, cfg, batch: Dict[str, torch.Tensor], logs: str,
                 fail_rank: Optional[int] = None) -> dict:
    """A ``Trainer`` with ``synth_eval`` on the (``cfg.mesh``) mesh of
    ``group``'s ranks writes the eval dump of ``batch`` into ``logs``;
    returns how often this rank synthesized.  ``fail_rank``: that rank's
    synthesis raises before the split GPT runs."""
    from detail_tts_tpu_torch.train.trainer import Trainer

    tr = Trainer(cfg, device="cpu", seed=0, logs_folder=logs, synth_eval=True, group=group)
    synth, calls = tr._synth_eval, []

    def counted(first, step):
        calls.append(step)
        if mesh.rank(group) == fail_rank:
            raise RuntimeError("eval exploded")
        return synth(first, step)

    tr._synth_eval = counted
    try:
        tr._eval_dump(batch)
    finally:
        tr.close()
    return {"synthesized": len(calls)}


def region_ops_call(group, x, w_col, w_row, logits, targets) -> dict:
    """Megatron's operators over a model group of every rank: a
    column-parallel then row-parallel pair on ``x`` (w_col (in, hidden),
    w_row (hidden, out), split by columns and rows), the vocab-parallel
    cross-entropy and the gathered logits of ``logits`` (N, V) split by
    columns; each forward and the gradients with respect to the full
    inputs (this rank's slices gathered)."""
    m = mesh.make_mesh(1, mesh.world(group), group)
    tp = mesh.Shard(m.model_group, m.model_rank, m.model)
    col, row, vocab = tp._replace(axis=1), tp._replace(axis=0), tp._replace(axis=1)
    x = x.clone().requires_grad_(True)
    wc = mesh.shard_tensor(w_col, col).requires_grad_(True)
    wr = mesh.shard_tensor(w_row, row).requires_grad_(True)
    y = mesh.reduce_from_model(torch.tanh(mesh.copy_to_model(x, tp) @ wc) @ wr, tp)
    y.square().sum().backward()
    lg = mesh.shard_tensor(logits, vocab).requires_grad_(True)
    ce = mesh.vocab_parallel_cross_entropy(lg, targets, tp)
    ce.backward()
    lg2 = mesh.shard_tensor(logits, vocab).requires_grad_(True)
    full = mesh.gather_from_model(lg2, tp)
    (full * torch.arange(full.shape[-1], dtype=full.dtype)).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw_col": mesh.gather_tensor(wc.grad, col),
            "dw_row": mesh.gather_tensor(wr.grad, row), "ce": ce.detach(),
            "dlogits": mesh.gather_tensor(lg.grad, vocab), "gathered": full.detach(),
            "dgathered": mesh.gather_tensor(lg2.grad, vocab)}


def engine_requests(group, data, model, cfg, ecfg, texts, wavs, seed: int = 3) -> dict:
    """A (data x model) engine of seeded random weights over ``group``'s
    ranks (the one-card engine without a group) answers one request through
    each entry: ``synthesize_batch`` under ``force_full``, the split
    dispatch with early stop, ``synthesize_vq_batch`` and
    ``synthesize_from_ids``; every rank returns every item."""
    from detail_tts_tpu_torch.serving.pipeline import random_engine

    m = None if group is None else mesh.make_mesh(data, model, group)
    eng = random_engine(cfg, engine_cfg=ecfg, device="cpu", mesh=m)
    text, _ = eng.prepare_text(texts)
    refer_mel, refer_len = eng.prepare_prompt(wavs)
    return {"batch": eng.synthesize_batch(texts, wavs, seed=seed, force_full=True),
            "split": eng.finalize_batch(eng.dispatch_tail(eng.dispatch_decode(
                texts, wavs, seed=seed + 1))),
            "vq": eng.synthesize_vq_batch(texts, wavs, seed=seed + 2),
            "ids": eng.synthesize_from_ids(text, refer_mel, refer_len, seed=seed + 3)}


def engine_tail(group, data, model, cfg, ecfg, texts, wavs, codes, eff,
                device="cpu") -> tuple:
    """The deterministic tail of a (data x model) engine (JAX's
    ``tests/test_serving_mesh.py`` ``_deterministic_tail``): fixed codes ->
    (latents, mel, wav) of every item on the CPU, with fixed generators and
    this data rank's rows gathered."""
    from detail_tts_tpu_torch.audio.mel import FRAMES_PER_CODE
    from detail_tts_tpu_torch.serving.pipeline import random_engine

    m = None if group is None else mesh.make_mesh(data, model, group)
    eng = random_engine(cfg, engine_cfg=ecfg, device=device, mesh=m)
    dev = eng.device
    rows = eng._rows(len(texts))
    mine = slice(None) if rows is None else slice(rows.start, rows.stop)
    with torch.inference_mode():
        text, _ = eng.prepare_text(texts[mine])
        refer_mel, refer_len = eng.prepare_prompt(wavs[mine])
        codes_b, wav_len, bucket = eng._pad_codes(codes[mine].to(dev), eff[mine])
        latents = eng.model.gpt(refer_mel, refer_len, text, codes_b, wav_len)
        mel = eng.diffuse(latents, eng.diffusion_cond(refer_mel, refer_len),
                          eng.attention_biases(bucket * FRAMES_PER_CODE),
                          torch.Generator(device=dev).manual_seed(7), rows)
        wav = eng._vocode(mel, eff[mine], torch.Generator(device=dev).manual_seed(8),
                          rows)[..., 0]
    out = (latents, mel, wav)
    if rows is not None and rows.stop - rows.start < rows.total:
        out = tuple(mesh.all_gather_rows(x, m.data_group) for x in out)
    return tuple(x.cpu() for x in out)


# ------------------------------------------------ front ends over a mesh engine

FRONT_WAIT_S = 120.0  # for any one future or HTTP call
IDLE_TIMEOUT_S = 3.0  # the control channel's timeout in the idle check


def _http():
    import urllib.request

    return urllib.request.build_opener(urllib.request.ProxyHandler({}))  # no proxy


def _failure(fut):
    """(type name, message) of a future that must fail."""
    try:
        fut.result(timeout=FRONT_WAIT_S)
    except Exception as e:  # noqa: BLE001 - the future's own exception
        return type(e).__name__, str(e)
    return None


def frontends_scenario(engine, requests, long_text, full: bool) -> dict:
    """The front ends over ``engine`` (a ``LeaderEngine`` or a one-card
    ``TTSEngine``): a ``TTSServer`` answers ``requests`` (text, prompt,
    seed) as one batch of 4, then as two back-to-back batches of 2.  With
    ``full``: batches of 2 whose texts are ``boom`` or ``fault`` (a fault
    planted on every rank, or on rank 1 only, of a mesh), each followed by
    a good batch; ``synthesize_long`` and ``synthesize_long_stream`` of
    ``long_text``; the HTTP endpoint (``/healthz``, one ``/synthesize``, a
    bad request), shut down through ``httpd_box``."""
    import base64
    import json
    import threading
    import urllib.error
    import urllib.request

    from detail_tts_tpu_torch.serving.http_api import (_decode_wav_bytes,
                                                       _encode_wav_bytes, serve)
    from detail_tts_tpu_torch.serving.longform import synthesize_long, synthesize_long_stream
    from detail_tts_tpu_torch.serving.server import TTSServer

    out = {}
    with TTSServer(engine, max_batch=4, max_wait_ms=1000.0) as server:
        futs = [server.submit(t, w, seed=s) for t, w, s in requests]
        out["four"] = [f.result(timeout=FRONT_WAIT_S) for f in futs]
    with TTSServer(engine, max_batch=2, max_wait_ms=1000.0) as server:
        futs = [server.submit(t, w, seed=s) for t, w, s in requests]
        out["pairs"] = [f.result(timeout=FRONT_WAIT_S) for f in futs]
        if full:
            for marker in ("boom", "fault"):
                futs = [server.submit(marker, w, seed=s) for _, w, s in requests[:2]]
                futs += [server.submit(t, w, seed=s) for t, w, s in requests[:2]]
                out[marker] = [_failure(f) for f in futs[:2]]
                out[marker + " next"] = [f.result(timeout=FRONT_WAIT_S) for f in futs[2:]]
    out["batches"] = server.batches_dispatched
    if not full:
        return out
    prompt = requests[0][1]
    out["long"] = synthesize_long(engine, long_text, prompt, seed=7, batch_size=2)
    out["stream"] = list(synthesize_long_stream(engine, long_text, prompt, seed=7,
                                                batch_size=2))
    box = {}
    thread = threading.Thread(target=serve, kwargs=dict(
        engine=engine, port=0, max_batch=2, max_wait_ms=5.0, httpd_box=box), daemon=True)
    thread.start()
    end = time.monotonic() + FRONT_WAIT_S
    while "httpd" not in box and time.monotonic() < end:
        time.sleep(0.01)
    host, port = box["httpd"].server_address
    url = f"http://{host}:{port}"
    try:
        with _http().open(url + "/healthz", timeout=FRONT_WAIT_S) as r:
            out["health"] = json.loads(r.read())
        text, wav, seed = requests[1]
        for name, prompt_bytes in (("http", _encode_wav_bytes(wav, 24000)),
                                   ("http bad", _encode_wav_bytes(wav[:16], 24000))):
            body = json.dumps({"text": text, "seed": seed,
                               "prompt_wav_b64": base64.b64encode(prompt_bytes).decode()})
            req = urllib.request.Request(url + "/synthesize", data=body.encode(),
                                         headers={"Content-Type": "application/json"})
            try:
                with _http().open(req, timeout=FRONT_WAIT_S) as r:
                    out[name] = (r.status, _decode_wav_bytes(r.read(), 24000))
            except urllib.error.HTTPError as e:
                out[name] = (e.code, None)
    finally:
        box["httpd"].shutdown()
        thread.join(timeout=FRONT_WAIT_S)
    out["http alive"] = thread.is_alive()
    return out


def recorded(engine) -> Dict[str, list]:
    """Record on ``engine`` (its instance attributes) the name of each of
    its entry points called, in order, and each ``dispatch_tail``'s rows and
    codes."""
    from detail_tts_tpu_torch.serving.spmd import CALLS

    log = {"calls": [], "codes": []}

    def wrap(name, fn):
        def run(*args, **kwargs):
            log["calls"].append(name)
            if name == "dispatch_tail":
                p = args[0]
                log["codes"].append((p.rows, p.codes.clone()))
            return fn(*args, **kwargs)
        return run

    for name in CALLS:
        setattr(engine, name, wrap(name, getattr(engine, name)))
    return log


def plant_faults(engine, rank: int) -> None:
    """``dispatch_decode`` of a batch of ``boom`` texts raises on every rank
    before it runs; of ``fault`` texts on rank 1 only, after it ran (so no
    rank waits in a collective)."""
    real = engine.dispatch_decode

    def faulty(texts, *args, **kwargs):
        if "boom" in texts:
            raise RuntimeError("planted on every rank")
        out = real(texts, *args, **kwargs)
        if "fault" in texts and rank == 1:
            raise RuntimeError("planted on rank 1")
        return out

    engine.dispatch_decode = faulty


def mesh_frontends(group, data, model, cfg, ecfg, requests, long_text, full: bool) -> dict:
    """:func:`frontends_scenario` on a (data x model) engine of seeded
    random weights: rank 0 through a ``LeaderEngine``, every other rank in
    ``follow``; each rank returns its :func:`recorded` log.  With ``full``
    (faults planted) a second channel with a timeout of
    ``IDLE_TIMEOUT_S`` then idles for twice that before one call."""
    import datetime

    from detail_tts_tpu_torch.serving.pipeline import random_engine
    from detail_tts_tpu_torch.serving.spmd import LeaderEngine, follow

    m = mesh.make_mesh(data, model, group)
    eng = random_engine(cfg, engine_cfg=ecfg, device="cpu", mesh=m)
    log = recorded(eng)
    if full:
        plant_faults(eng, m.rank)
    if m.rank == 0:
        with LeaderEngine(eng) as leader:
            out = frontends_scenario(leader, requests, long_text, full)
    else:
        out = {"followed": follow(eng)}
    out["log"] = log
    if full:
        mesh.barrier(group)
        short = datetime.timedelta(seconds=IDLE_TIMEOUT_S)
        texts, wavs, _ = zip(*requests)
        if m.rank == 0:
            with LeaderEngine(eng, timeout=short) as leader:
                time.sleep(2 * IDLE_TIMEOUT_S)
                out["after idle"] = leader.synthesize_vq_batch(list(texts[:2]),
                                                               list(wavs[:2]), seed=5)
        else:
            out["followed after idle"] = follow(eng, timeout=short)
    return out


def refused_requests(group, data, model, cfg, ecfg, texts, wavs) -> dict:
    """Requests that the one-card engine refuses, on a (data x model)
    engine (one card without a group): each entry's ``ValueError`` message
    (None where it returned).  After each call the ranks meet in a barrier
    of a group of their own, as a server's ranks agree a call's outcome: a
    rank that raised while another waits in a collective of the engine
    leaves both waiting."""
    import torch.distributed as dist

    from detail_tts_tpu_torch.serving.pipeline import random_engine

    m = None if group is None else mesh.make_mesh(data, model, group)
    after = None if group is None else dist.new_group(backend="gloo")
    eng = random_engine(cfg, engine_cfg=ecfg, device="cpu", mesh=m)
    short = list(wavs[:-1]) + [wavs[-1][:100]]  # the last row: less than one hop
    text = torch.zeros((len(texts), 8), dtype=torch.long)
    mel = torch.zeros((len(texts) - 1, 32, cfg.data.n_mel_channels))
    calls = {"dispatch_decode": lambda: eng.dispatch_decode(texts, short),
             "synthesize_batch": lambda: eng.synthesize_batch(texts, short),
             "synthesize_vq_batch": lambda: eng.synthesize_vq_batch(texts, short),
             "synthesize_from_ids": lambda: eng.synthesize_from_ids(
                 text, mel, torch.full((len(texts),), 32))}
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
        mesh.barrier(after)
    return out
