"""Command-line entry points: `python -m gubernator_tpu_torch.cli.server`
(the daemon, reference cmd/gubernator/main.go)."""
