from repro_torch.train.serve_step import ServeSetup  # noqa: F401
from repro_torch.train.train_step import TrainConfig, TrainSetup  # noqa: F401
