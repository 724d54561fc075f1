"""Offline data-prep demo on the PyTorch port, the twin of prepare_demo.py.

Runs every phase end to end on a directory of raw recordings:
  1. VAD: split raw audio on silence into 0.7-30 s clips at 24 kHz
     (reference prepare/vad_process.py + 0_vad_asr_save_to_jsonl.py);
  2. transcripts -> jsonl: the transcripts passthrough for corpora that
     already ship text (ASR is pluggable: ``data/prepare.py asr_to_jsonl``);
  3. VQ extraction: the frozen encoder's codes saved beside each clip
     (prepare/extract_vq.py:18-46);
  4. sanity: one bucketed, padded training batch through
     JsonlTtsDataset/DataIterator, to show that the output is trainable.

Run:  python examples/prepare_demo_torch.py --in-dir raw/ --work-dir out/ \\
          [--transcripts table.tsv] [--ckpt trainer_ckpt_dir] [--cpu] [--small]

It runs on the GPU unless --cpu is given (without a GPU and without --cpu
it stops with the port's CUDA error).  --ckpt names a checkpoint directory
that the port's trainer wrote (``<logs>/ckpt``: its newest step, weight
norm folded), where prepare_demo.py takes an Orbax directory.  Without
--transcripts every clip gets a placeholder transcript, so the pipeline
still runs end to end; without --ckpt the VQ encoder has seeded random
weights (the codes are valid indices, not meaningful ones).
"""
import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PLACEHOLDER_TEXT = "你好世界，这是一条数据准备演示语句。"


def prepare(in_dir, work_dir, sr, transcripts=None, text=PLACEHOLDER_TEXT):
    """Phases 1-2: every wav under ``in_dir`` cut into clips under
    ``work_dir/clips``, and their transcripts (``text`` for each clip
    without ``transcripts``) into ``work_dir/data.jsonl``.  Returns (raw
    recordings, clips, jsonl rows written, jsonl path)."""
    from detail_tts_tpu_torch.data.prepare import (load_transcript_table,
                                                   transcripts_to_jsonl, vad_directory)

    clips_dir = os.path.join(work_dir, "clips")
    jsonl = os.path.join(work_dir, "data.jsonl")
    os.makedirs(work_dir, exist_ok=True)
    raw = sorted(glob.glob(os.path.join(in_dir, "**/*.wav"), recursive=True))
    clips = vad_directory(raw, clips_dir, sr=sr, workers=1)
    if transcripts:
        pairs = load_transcript_table(transcripts)
    else:  # placeholder text keeps the demo self-contained
        pairs = [(c, text) for c in clips]
    n = transcripts_to_jsonl(pairs, jsonl, clips_dir=clips_dir)
    return raw, clips, n, jsonl


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--in-dir", required=True, help="raw recordings (wav)")
    p.add_argument("--work-dir", required=True)
    p.add_argument("--transcripts", default=None,
                   help="jsonl/tsv/'|' table of (clip path, text); "
                        "relative paths resolve against the clips dir")
    p.add_argument("--ckpt", default=None,
                   help="a checkpoint dir the port's trainer wrote (<logs>/ckpt)")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--small", action="store_true",
                   help="small_test_config() model (smoke runs)")
    args = p.parse_args(argv)

    import torch

    from detail_tts_tpu_torch.config import Config, small_test_config
    from detail_tts_tpu_torch.data.dataset import BucketSpec, DataIterator, JsonlTtsDataset
    from detail_tts_tpu_torch.data.prepare import extract_vq
    from detail_tts_tpu_torch.serving.pipeline import resolve_device
    from detail_tts_tpu_torch.text.tokenizer import make_tokenizer

    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = small_test_config() if args.small else Config()

    # -- phases 1-2: VAD, transcripts -> jsonl ------------------------------
    raw, clips, n, jsonl = prepare(args.in_dir, args.work_dir, cfg.data.sampling_rate,
                                   args.transcripts)
    print(f"[1/4] vad: {len(raw)} recordings -> {len(clips)} clips")
    print(f"[2/4] jsonl: {n} rows -> {jsonl}")

    # -- phase 3: VQ extraction ----------------------------------------------
    if args.ckpt:
        from detail_tts_tpu_torch.train.checkpoint import restore_variables

        state_dict = restore_variables(args.ckpt, cfg)
    else:
        from detail_tts_tpu_torch.io.weights import random_weights_
        from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn

        with torch.device(device):
            model = SynthesizerTrn(cfg)
        state_dict = random_weights_(model, 0).state_dict()
    n = extract_vq(jsonl, cfg, state_dict, device=device)
    print(f"[3/4] vq: encoded {n} clips (.vq.npy beside each wav)")

    # -- phase 4: one training batch through the loader -----------------------
    ds = JsonlTtsDataset(cfg, jsonl, make_tokenizer(cfg.data.tokenizer_vocab))
    it = DataIterator(ds, micro_batch=min(2, len(ds)), buckets=BucketSpec(), num_threads=1,
                      seed=0)
    batch = next(iter(it))
    it.close()
    print("[4/4] batch:", {k: tuple(v.shape) for k, v in sorted(batch.items())})


if __name__ == "__main__":
    main()
