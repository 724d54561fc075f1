"""Data-prep CLI (the reference's prepare/ scripts, with argparse).

  python -m detail_tts_tpu_torch.data.prepare_cli vad --in-dir raw/ --out-dir clips/
  python -m detail_tts_tpu_torch.data.prepare_cli transcripts \\
      --table metadata.tsv --jsonl data.jsonl [--clips-dir clips/]
  python -m detail_tts_tpu_torch.data.prepare_cli asr --clips-dir clips/ \\
      --jsonl data.jsonl --recognizer mypkg.myasr
  python -m detail_tts_tpu_torch.data.prepare_cli extract-vq --jsonl data.jsonl \\
      --ckpt logs/.../ckpt [--config config.json] [--device cuda]

``transcripts`` takes a corpus's existing transcripts (jsonl, tab-separated
or LJSpeech ``|`` tables) in place of ASR.  ``asr`` needs a module with
``transcribe(wav: np.ndarray, sr: int) -> str``.  ``extract-vq`` reads a
checkpoint directory the trainer wrote and runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import glob
import importlib
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    v = sub.add_parser("vad")
    v.add_argument("--in-dir", required=True)
    v.add_argument("--out-dir", required=True)
    v.add_argument("--sr", type=int, default=24000)
    v.add_argument("--workers", type=int, default=12)
    v.add_argument("--silence-db", type=float, default=-40.0)
    v.add_argument("--min-silence-ms", type=int, default=500)

    a = sub.add_parser("asr")
    a.add_argument("--clips-dir", required=True)
    a.add_argument("--jsonl", required=True)
    a.add_argument("--recognizer", required=True,
                   help="module with transcribe(wav, sr) -> str")
    a.add_argument("--workers", type=int, default=4)

    t = sub.add_parser("transcripts",
                       help="existing transcripts -> jsonl, in place of ASR "
                            "(jsonl/tsv/LJSpeech '|' tables)")
    t.add_argument("--table", required=True)
    t.add_argument("--jsonl", required=True)
    t.add_argument("--clips-dir", default=None,
                   help="base dir for relative paths in the table")

    e = sub.add_parser("extract-vq")
    e.add_argument("--jsonl", required=True)
    e.add_argument("--ckpt", required=True, help="a checkpoint dir the trainer wrote")
    e.add_argument("--config", default=None)
    e.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    args = p.parse_args(argv)

    if args.cmd == "vad":
        from detail_tts_tpu_torch.data.prepare import vad_directory

        paths = sorted(q for ext in ("wav", "flac", "mp3")
                       for q in glob.glob(os.path.join(args.in_dir, f"**/*.{ext}"),
                                          recursive=True))
        written = vad_directory(paths, args.out_dir, sr=args.sr, workers=args.workers,
                                silence_thresh_db=args.silence_db,
                                min_silence_ms=args.min_silence_ms)
        print(f"wrote {len(written)} clips from {len(paths)} files")
    elif args.cmd == "asr":
        from detail_tts_tpu_torch.data.prepare import asr_to_jsonl

        mod = importlib.import_module(args.recognizer)
        clips = sorted(glob.glob(os.path.join(args.clips_dir, "*.wav")))
        n = asr_to_jsonl(clips, args.jsonl, mod.transcribe, workers=args.workers)
        print(f"wrote {n} rows to {args.jsonl}")
    elif args.cmd == "transcripts":
        from detail_tts_tpu_torch.data.prepare import (load_transcript_table,
                                                       transcripts_to_jsonl)

        n = transcripts_to_jsonl(load_transcript_table(args.table), args.jsonl,
                                 clips_dir=args.clips_dir)
        print(f"wrote {n} rows to {args.jsonl}")
    elif args.cmd == "extract-vq":
        from detail_tts_tpu_torch.config import Config
        from detail_tts_tpu_torch.data.prepare import extract_vq
        from detail_tts_tpu_torch.train.checkpoint import restore_variables

        cfg = Config.from_json(args.config) if args.config else Config()
        n = extract_vq(args.jsonl, cfg, restore_variables(args.ckpt, cfg),
                       device=args.device)
        print(f"encoded {n} files")


if __name__ == "__main__":
    main()
