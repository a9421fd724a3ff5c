from rendering_tpu_torch.cli import entry

raise SystemExit(entry())
