"""End-to-end training through the PyTorch port (the counterpart of
examples/train_lm.py): the zero-copy page pipeline, the two-stage
gradient aggregation, atomic checkpointing with a simulated mid-run
failure and the supervised restart, on the card unless --device names
another.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200]
      PYTHONPATH=src python examples/torch_train_lm.py --tiny --device cpu
(xlstm-125m at its full size; --tiny for the reduced config, seconds
instead of minutes.)
"""
import argparse
import tempfile

from repro_torch.launch.train import train_loop


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (seconds instead of minutes)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()

    with tempfile.TemporaryDirectory() as ckpt:
        out = train_loop(
            "xlstm_125m",
            reduced=args.tiny,  # full 125M config unless --tiny
            steps=args.steps,
            batch=4 if not args.tiny else 8,
            seq=256 if not args.tiny else 64,
            ckpt_dir=ckpt,
            save_every=max(10, args.steps // 10),
            fail_at=args.steps // 2,  # simulated node failure mid-run
            lr=6e-4,
            log_every=10,
            device=args.device,
        )
    rep = out["report"]
    print(f"\nfinal loss {out['losses'][-1]:.4f} "
          f"(start {out['losses'][0]:.4f}) in {out['seconds']:.0f}s")
    print(f"supervisor: {rep.steps_run} steps, {rep.restarts} restart(s) "
          f"from checkpoints {rep.restored_from}")
    assert out["losses"][-1] < out["losses"][0]


if __name__ == "__main__":
    main()
