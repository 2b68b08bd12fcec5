"""Command-line entry points (reference cmd/ parity):

- python -m gubernator_tpu_torch.cli.server       — the daemon
  (cmd/gubernator/main.go)
- python -m gubernator_tpu_torch.cli.bench_client — load generator
  (cmd/gubernator-cli/main.go)
- python -m gubernator_tpu_torch.cli.cluster      — local dev cluster
  (cmd/gubernator-cluster/main.go)
- python -m gubernator_tpu_torch.cli.healthcheck  — container health probe
  (cmd/healthcheck/main.go)
- python -m gubernator_tpu_torch.cli.gubload      — open-loop scenarios
- python -m gubernator_tpu_torch.cli.gubtop       — cluster screen
- python -m gubernator_tpu_torch.cli.flightrec    — flight-recorder dumps
"""
