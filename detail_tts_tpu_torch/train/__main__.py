"""Training CLI: the reference's ``accelerate launch train.py``.

Usage:
  python -m detail_tts_tpu_torch.train --data data.jsonl \\
      [--config config.json] [--target diff] [--resume logs/.../ckpt] \\
      [--steps N] [--logs-folder logs/run] [--num-workers 8] [--device cuda]

Every knob is a flag (the reference hard-codes its paths,
train.py:462-465).  The run trains on the card unless ``--device cpu`` is
given.  ``--resume`` restores a checkpoint directory the trainer wrote
(its newest step), partially where the target differs.

Data parallel on N cards of one host (one process a card, NCCL):
  torchrun --nproc_per_node N -m detail_tts_tpu_torch.train --data ... \
      --logs-folder logs/run
``batch_size`` is then the global micro-batch, ``batch_size // N`` clips a
card.  With ``WORLD_SIZE`` unset the run is one process, as above.

A (D x M) mesh: ``--model-parallel M`` (``cfg.mesh.model_parallel``) splits
the GPT over M cards (Megatron tensor parallelism, ``parallel/mesh.py``)
and the rows over D = N / M; rank r sits at (r // M, r % M):
  torchrun --nproc_per_node N -m detail_tts_tpu_torch.train --data ... \
      --model-parallel M --logs-folder logs/run
``batch_size // D`` clips a card then, the same on the M cards of a row.
"""
from __future__ import annotations

import argparse
import dataclasses
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=None, help="reference-format JSON")
    p.add_argument("--data", required=True, help="jsonl with {path, text}")
    p.add_argument("--target", default=None,
                   choices=["vqvae", "gpt", "diff", "flowvae", "all"])
    p.add_argument("--resume", default=None, help="checkpoint dir to resume")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--logs-folder", default=None)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--model-parallel", type=int, default=None,
                   help="cards a GPT is split over (cfg.mesh.model_parallel)")
    args = p.parse_args(argv)

    import torch.distributed as dist

    from detail_tts_tpu_torch.config import Config
    from detail_tts_tpu_torch.parallel.mesh import init_distributed
    from detail_tts_tpu_torch.train.trainer import Trainer

    cfg = Config.from_json(args.config) if args.config else Config()
    if args.target:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, target=args.target))
    if args.model_parallel:
        cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
            cfg.mesh, model_parallel=args.model_parallel))

    group, device = None, args.device
    if "WORLD_SIZE" in os.environ:  # under torchrun
        group, device = init_distributed(device=args.device)
    try:
        trainer = Trainer(cfg, device=device, logs_folder=args.logs_folder, group=group)
        try:
            trainer.default_data(args.data, num_threads=args.num_workers)
            if args.resume:
                trainer.load(args.resume)
            return trainer.train(max_steps=args.steps)
        finally:
            trainer.close()
    finally:
        if group is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
