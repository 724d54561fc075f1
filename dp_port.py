"""Data-parallel training of the port on the cards of one host, under torchrun.

    torchrun --nproc_per_node 4 dp_port.py [--target diff] [--micro 32]
        [--accum 2] [--steps 3] [--device cuda|cpu] [--small]

Rank 0 first runs the plain (world-1) Trainer on the global batches
(``--micro`` rows x 496 frames x ``--accum``, seeded on its device) while
the other ranks wait; then every rank runs the data-parallel Trainer on its
``micro / W`` rows of the same batches over NCCL (gloo on the CPU).  Each
step prints the loss and grad norm against world 1's, whether the ranks'
trainable tensors and buffers are bit-identical (SHA-256 gathered from
every rank), the gradient all-reduce's wall (the step's ``allreduce``
stage, synchronised; the slowest rank's), the step's wall and each rank's
peak device memory.  It exits non-zero when the ranks differ or loss or
grad norm is more than 1e-3 relative from world 1's.  ``--small`` runs
``small_test_config()`` at 48 frames (a rehearsal on the CPU); the card's
name and power limit are printed first on a card.
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
from detail_tts_tpu_torch.parallel import mesh
from detail_tts_tpu_torch.train.step import synthetic_batches
from detail_tts_tpu_torch.train.trainer import Trainer

TOL = 1e-3  # the route check's relative tolerance (PERF.md §2)


def digest(state) -> torch.Tensor:
    """SHA-256 of every trainable tensor and buffer, as 32 bytes."""
    h = hashlib.sha256()
    for t in list(state.params) + list(state.model.buffers()):
        h.update(t.detach().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return torch.frombuffer(bytearray(h.digest()), dtype=torch.uint8)


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
    args = p.parse_args(argv)

    group, dev = mesh.init_distributed(device=args.device)
    rank, world = mesh.rank(group), mesh.world(group)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = small_test_config() if args.small else Config()
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, target=args.target, batch_size=args.micro,
        gradient_accumulate_every=args.accum))
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
    say(f"python {sys.version.split()[0]} torch {torch.__version__} world {world} "
        f"backend {dist.get_backend(group)} target {args.target} global micro-batch "
        f"{args.micro} ({args.micro // world} a rank) x {frames} frames x accum {args.accum}")
    logs = tempfile.mkdtemp(prefix="dp_port_")
    ok = True
    ref = []
    if rank == 0:  # world 1 on the global batches
        plain = Trainer(cfg, batches(), device=dev, seed=0, logs_folder=logs + "/w1")
        for _ in range(args.steps):
            plain.train(max_steps=plain.state.step + 1, log_every=1)
            ref.append({k: float(v) for k, v in plain.last_metrics.items()
                        if torch.is_tensor(v)})
        plain.close()
        del plain
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    mesh.barrier(group)

    data = (mesh.shard_batch(b, group, 1) for b in batches())
    trainer = Trainer(cfg, data, device=dev, seed=0, logs_folder=logs + "/dp", group=group)
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
        every = mesh.all_gather_host(torch.tensor([timings["allreduce"], wall, peak],
                                                  dtype=torch.float64), group)
        digests = mesh.all_gather_host(digest(trainer.state), group)
        same = bool((digests == digests[0]).all())
        loss, norm = m["loss"].item(), m["grad_norm"].item()
        if rank == 0:
            rel = {"loss": abs(loss - ref[i]["loss"]) / abs(ref[i]["loss"]),
                   "grad_norm": abs(norm - ref[i]["grad_norm"]) / abs(ref[i]["grad_norm"])}
            ok &= same and all(r <= TOL for r in rel.values())
            print(json.dumps({"step": i + 1, "loss": loss, "world1_loss": ref[i]["loss"],
                              "grad_norm": norm, "world1_grad_norm": ref[i]["grad_norm"],
                              "relative": rel, "ranks_bit_identical": same,
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


if __name__ == "__main__":
    main()
