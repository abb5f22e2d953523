"""Project path constants (copy of ``lightning_generative_models_tpu/utils/path.py``)."""

from pathlib import Path

PROJECT_ROOT = Path(__file__).resolve().parents[2]
DATASET_PATH = PROJECT_ROOT / "data" / "dataset"
EXPERIMENT_DIR = PROJECT_ROOT / "experiments"
