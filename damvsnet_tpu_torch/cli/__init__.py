"""Command-line entry points (counterpart of damvsnet_tpu/cli)."""
