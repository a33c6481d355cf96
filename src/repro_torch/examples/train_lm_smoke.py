"""Train a small LM (llama3.2-1b reduced config) with the full substrate:
prefetching pipeline, AdamW, async checkpointing, and a simulated node
failure + restart (port of ``examples/train_lm_smoke.py``).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm_smoke [--device cpu]
"""
import argparse
import shutil
import tempfile

from repro_torch.launch.train import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        print("=== phase 1: train with a failure injected at step 30 ===")
        try:
            train("llama3.2-1b", "train_4k", smoke=True, steps=60,
                  ckpt_dir=ckpt_dir, ckpt_every=10, fail_at=30, device=args.device)
        except RuntimeError as e:
            print(f"!! {e} — restarting from the latest checkpoint")

        print("=== phase 2: restart resumes from the checkpoint ===")
        out = train("llama3.2-1b", "train_4k", smoke=True, steps=60,
                    ckpt_dir=ckpt_dir, ckpt_every=10, device=args.device)
        print(f"resumed and finished: loss {out['first_loss']:.3f} -> "
              f"{out['last_loss']:.3f} in {out['seconds']:.1f}s")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
