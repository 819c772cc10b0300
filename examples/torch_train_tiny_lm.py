"""Train a reduced qwen2-family model on the PyTorch port for a few
hundred steps on the synthetic token pipeline, with checkpoints and one
injected mid-run failure (the loop restores the last checkpoint and goes
on), as ``train_tiny_lm.py`` does on the JAX package.

  PYTHONPATH=src python examples/torch_train_tiny_lm.py [--device cpu]
"""
import argparse
import tempfile

from repro_torch.launch import train


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=120,
                    help="the step of the injected failure (once)")
    args = ap.parse_args(argv)
    failed = []

    def inject(step: int) -> bool:
        if step == args.fail_at and not failed:
            failed.append(step)
            return True
        return False

    with tempfile.TemporaryDirectory() as ckpt:
        log = train.main([
            "--arch", "qwen2-7b", "--scale", "smoke",
            "--steps", str(args.steps), "--batch", str(args.batch),
            "--seq", str(args.seq), "--lr", "3e-3",
            "--save-every", str(args.save_every), "--ckpt-dir", ckpt,
            "--device", args.device], inject=inject)
    first, last = log[0]["loss"], log[-1]["loss"]
    assert failed, "the failure was not injected"
    assert log[-1]["step"] == args.steps
    assert last < first, "training must reduce loss"
    print(f"\nOK: {args.steps} steps ({len(log)} run, a failure at step "
          f"{failed[0]} restored from the last checkpoint), loss "
          f"{first:.3f} -> {last:.3f}")
    return log


if __name__ == "__main__":
    main()
