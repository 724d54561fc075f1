"""The port on the cards of one host, under torchrun: data- and
tensor-parallel training steps, or one sharded request, against world 1.

    torchrun --nproc_per_node 4 dp_port.py [--target diff] [--micro 32]
        [--accum 2] [--steps 3] [--model-parallel 1] [--no-dropout] [--fp32]
        [--device cuda|cpu] [--small]
    torchrun --nproc_per_node 4 dp_port.py --serve [--batch 8] [--codes 400]
        [--model-parallel 1] [--device cuda|cpu] [--small]

Rank 0 first runs the plain (world-1) Trainer on the global batches
(``--micro`` rows x 496 frames x ``--accum``, seeded on its device) while
the other ranks wait; then every rank runs the data-parallel Trainer on its
``micro / W`` rows of the same batches over NCCL (gloo on the CPU).  Each
step prints the loss and grad norm against world 1's, whether the ranks'
trainable tensors and buffers are bit-identical (SHA-256 gathered from
every rank), the gradient all-reduce's wall (the step's ``allreduce``
stage, synchronised; the slowest rank's), the step's wall and each rank's
peak device memory.  It exits non-zero when the ranks differ or loss or
grad norm is more than 1e-3 relative from world 1's.  ``--model-parallel
M`` runs the steps on the (W / M x M) mesh (``cfg.mesh.model_parallel``;
rank r at (r // M, r % M)): the GPT is split over each row's M cards, the
rows of the batch over the D = W / M data ranks, and the digests are of
the replicated tensors (every rank's must agree) and of the shards (the
ranks of one model rank must agree).  ``--no-dropout`` sets every dropout
to 0 in both runs: at D > 1 each data rank draws its own masks, so a
``gpt`` step meets world 1's only without them.  ``--fp32`` trains
without bf16 autocast; a step on a model axis under autocast is held at
``TP_BF16_TOL`` instead of 1e-3.

``--serve``: rank 0 first answers one request of ``--batch`` rows and
``--codes`` codes under force_full (ancestral, 50 steps, bf16; a warm-up
request first, as ``profile_port.py`` runs it) on a one-card engine; then
every rank answers the same request on the (W / M x M) sharded engine.  It
prints both walls, the stage walls (``timings``, each stage synchronised),
audio seconds per wall second, and how many codes agree with world 1's.

``--small`` runs ``small_test_config()`` at 48 frames (a rehearsal on the
CPU); the card's name and power limit are printed first on a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import shutil
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from detail_tts_tpu_torch.config import Config, small_test_config
from detail_tts_tpu_torch.nn.common import SeededDropout
from detail_tts_tpu_torch.parallel import mesh
from detail_tts_tpu_torch.train.step import synthetic_batches
from detail_tts_tpu_torch.train.trainer import Trainer

TOL = 1e-3  # the route check's relative tolerance (PERF.md §2)
# With the GPT split under bf16 autocast the partial sums round otherwise and
# Adam's ~lr steps on gradients near 0 move step 2's grad norm: 2.9e-3 read
# at (2 x 2) on four H100s (PERF.md §6, PR 11); --fp32 holds TOL.
TP_BF16_TOL = 5e-3


def digest(state, shards: bool = False) -> torch.Tensor:
    """SHA-256 of every trainable tensor that is not a model shard and every
    buffer (``shards``: of the trainable shards only), as 32 bytes."""
    h = hashlib.sha256()
    tensors = [p for p in state.params
               if (getattr(p, "model_shard", None) is not None) == shards]
    for t in tensors + ([] if shards else list(state.model.buffers())):
        h.update(t.detach().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return torch.frombuffer(bytearray(h.digest()), dtype=torch.uint8)


def no_dropout(model) -> None:
    for m in model.modules():
        if isinstance(m, SeededDropout):
            m.p = 0.0


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--target", default="diff", choices=["vqvae", "gpt", "diff"])
    p.add_argument("--micro", type=int, default=32, help="global micro-batch")
    p.add_argument("--accum", type=int, default=2)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--small", action="store_true")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="cards a GPT is split over (the mesh's model axis)")
    p.add_argument("--no-dropout", action="store_true", help="every dropout at 0")
    p.add_argument("--fp32", action="store_true", help="no bf16 autocast")
    p.add_argument("--serve", action="store_true", help="one sharded request")
    p.add_argument("--batch", type=int, default=8, help="--serve: rows of the request")
    p.add_argument("--codes", type=int, default=400, help="--serve: codes a row")
    args = p.parse_args(argv)

    group, dev = mesh.init_distributed(device=args.device)
    rank, world = mesh.rank(group), mesh.world(group)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = small_test_config() if args.small else Config()
    cfg = dataclasses.replace(
        base, train=dataclasses.replace(base.train, target=args.target,
                                        batch_size=args.micro,
                                        gradient_accumulate_every=args.accum,
                                        use_bf16=base.train.use_bf16 and not args.fp32),
        mesh=dataclasses.replace(base.mesh, model_parallel=args.model_parallel))
    frames, text = (48, 8) if args.small else (496, 64)

    def batches():
        return synthetic_batches(cfg, args.accum, args.micro, frames, text, device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(1))

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    if rank == 0 and dev.type == "cuda":
        say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip())
    data_world = world // args.model_parallel
    if args.serve:
        ok = serve(args, cfg, group, dev, say)
        mesh.barrier(group)
        dist.destroy_process_group()
        if rank == 0:
            print(json.dumps({"ok": ok}), flush=True)
        sys.exit(0 if ok else 1)
    say(f"python {sys.version.split()[0]} torch {torch.__version__} world {world} "
        f"backend {dist.get_backend(group)} mesh ({data_world} x {args.model_parallel}) "
        f"target {args.target} global micro-batch {args.micro} ({args.micro // data_world} "
        f"a data rank) x {frames} frames x accum {args.accum}")
    logs = tempfile.mkdtemp(prefix="dp_port_")
    ok = True
    ref = []
    if rank == 0:  # world 1 on the global batches
        plain = Trainer(dataclasses.replace(cfg, mesh=base.mesh), batches(), device=dev,
                        seed=0, logs_folder=logs + "/w1")
        if args.no_dropout:
            no_dropout(plain.state.model)
        for _ in range(args.steps):
            plain.train(max_steps=plain.state.step + 1, log_every=1)
            ref.append({k: float(v) for k, v in plain.last_metrics.items()
                        if torch.is_tensor(v)})
        plain.close()
        del plain
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    mesh.barrier(group)

    trainer = Trainer(cfg, None, device=dev, seed=0, logs_folder=logs + "/dp", group=group)
    trainer.data_iter = (mesh.shard_batch(b, trainer.data_group, 1) for b in batches())
    if args.no_dropout:
        no_dropout(trainer.state.model)
    for i in range(args.steps):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        timings = {}
        sync(dev)
        t0 = time.perf_counter()
        m = trainer.step_fn(trainer.state, trainer.next_batch(), trainer.generator,
                            timings=timings, dropout_generator=trainer.dropout_generator)
        sync(dev)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
        every = mesh.all_gather_host(torch.tensor([timings.get("allreduce", 0.0), wall, peak],
                                                  dtype=torch.float64), group)
        digests = mesh.all_gather_host(digest(trainer.state), group)
        same = bool((digests == digests[0]).all())
        # the shards of one model rank are alike on every data rank
        shards = mesh.all_gather_host(digest(trainer.state, shards=True), group)
        shards = shards.reshape(data_world, args.model_parallel, -1)
        same &= bool((shards == shards[:1]).all())
        loss, norm = m["loss"].item(), m["grad_norm"].item()
        if rank == 0:
            rel = {"loss": abs(loss - ref[i]["loss"]) / abs(ref[i]["loss"]),
                   "grad_norm": abs(norm - ref[i]["grad_norm"]) / abs(ref[i]["grad_norm"])}
            tol = TP_BF16_TOL if args.model_parallel > 1 and cfg.train.use_bf16 else TOL
            ok &= same and all(r <= tol for r in rel.values())
            print(json.dumps({"step": i + 1, "loss": loss, "world1_loss": ref[i]["loss"],
                              "grad_norm": norm, "world1_grad_norm": ref[i]["grad_norm"],
                              "relative": rel, "ranks_bit_identical": same,
                              "replicated_digests": [d[:4].tolist() for d in digests],
                              "shard_digests": [d[:4].tolist() for d in
                                                shards.reshape(world, -1)],
                              "allreduce_s_max": max(every[:, 0].tolist()),
                              "allreduce_s": every[:, 0].tolist(),
                              "step_wall_s": every[:, 1].tolist(),
                              "peak_gib": every[:, 2].tolist(),
                              "grads_mb": sum(p.numel() * 4 for p in trainer.state.params)
                              / 1e6}), flush=True)
    trainer.close()
    shutil.rmtree(logs, ignore_errors=True)
    mesh.barrier(group)
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps({"ok": ok}), flush=True)
    if not ok:
        sys.exit(1)



def request(engine, texts, prompts, timings=None):
    """One force_full request through the split dispatch, seed 0: (every
    item's codes, wavs, wall)."""
    sync(engine.device)
    t0 = time.perf_counter()
    pending = engine.dispatch_decode(texts, prompts, seed=0, force_full=True,
                                     timings=timings)
    codes, rows = pending.codes, pending.rows
    if rows is not None and rows.stop - rows.start < rows.total:
        codes = mesh.all_gather_rows(codes, engine.mesh.data_group)
    outs = engine.finalize_batch(engine.dispatch_tail(pending))
    sync(engine.device)
    return codes.cpu(), outs, time.perf_counter() - t0


def serve(args, cfg, group, dev, say) -> bool:
    """``--serve``: world 1 on rank 0, then the sharded engine on every rank."""
    import numpy as np

    from detail_tts_tpu_torch.serving.pipeline import EngineConfig, random_engine

    rank, world = mesh.rank(group), mesh.world(group)
    m = mesh.make_mesh(-1, args.model_parallel, group)
    ecfg = EngineConfig(max_generate_length=args.codes + 1)
    if args.small:
        ecfg = dataclasses.replace(ecfg, text_buckets=(16, 32), prompt_buckets=(32, 64),
                                   code_buckets=(8, 12), compute_dtype=torch.float32,
                                   cache_dtype=torch.float32)
    sr = cfg.data.sampling_rate
    rng = np.random.default_rng(0)
    prompts = [rng.uniform(-0.3, 0.3, 3 * sr).astype(np.float32) for _ in range(args.batch)]
    texts = ["今天天气很好，我们一起去公园散步吧。"] * args.batch
    say(f"python {sys.version.split()[0]} torch {torch.__version__} world {world} backend "
        f"{dist.get_backend(group)} serving mesh ({m.data} x {m.model}): batch {args.batch} x "
        f"{args.codes} codes, {ecfg.diffusion_sampler} {cfg.diffusion.infer_steps} steps, "
        f"{ecfg.compute_dtype}, force_full")
    runs = {}
    for name, engine_mesh in (("world1", None), ("sharded", m)):
        if engine_mesh is None and rank != 0:
            mesh.barrier(group)
            continue
        engine = random_engine(cfg, seed=0, engine_cfg=ecfg, device=dev, mesh=engine_mesh)
        if engine_mesh is not None and m.model > 1:
            say(mesh.describe_shards(engine.model, m))
        request(engine, texts, prompts)  # warm-up: builds the kernels, fills the caches
        timings = {}
        codes, outs, wall = request(engine, texts, prompts, timings)
        audio_s = sum(len(o) for o in outs) / sr
        runs[name] = (codes, outs, wall)
        if rank == 0:
            say(json.dumps({"engine": name, "wall_s": wall, "audio_s": audio_s,
                            "audio_s_per_wall_s": audio_s / wall, "timings": timings,
                            "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                                         if dev.type == "cuda" else 0.0)}))
        del engine
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if engine_mesh is None:
            mesh.barrier(group)
    walls = mesh.all_gather_host(torch.tensor([runs["sharded"][2]], dtype=torch.float64), group)
    if rank == 0:
        (c1, o1, w1), (cs, osh, ws) = runs["world1"], runs["sharded"]
        same_len = all(a.shape == b.shape for a, b in zip(o1, osh))
        wav = (max(float(np.abs(a - b).max()) for a, b in zip(o1, osh))
               / max(float(np.abs(a).max()) for a in o1)) if same_len else None
        say(json.dumps({"world1_wall_s": w1, "sharded_wall_s": ws,
                        "sharded_wall_s_per_rank": walls[:, 0].tolist(),
                        "wall_ratio": ws / w1,
                        "codes_equal_to_world1": float((cs == c1).float().mean()),
                        "items_of_world1_length": same_len,
                        "wav_max_abs_diff_over_max": wav}))
    return True


if __name__ == "__main__":
    main()
