"""Training: optimizer and EMA helpers, checkpoints, the fit loop, the CLI.

    python -m lightning_generative_models_tpu_torch.train --config_path <config> [...]
"""


def main(argv=None):
    """The training CLI (``train/cli.py``); returns the trained model."""
    from lightning_generative_models_tpu_torch.train.cli import main as cli_main  # noqa: PLC0415

    return cli_main(argv)
