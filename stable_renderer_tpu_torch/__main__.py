"""``python -m stable_renderer_tpu_torch <cmd>``: the command line (cli.py)."""

from stable_renderer_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
