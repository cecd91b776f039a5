from hypergef_tpu_torch.train.splits import accuracy, rand_train_test_idx
from hypergef_tpu_torch.train.trainer import TrainConfig, Trainer, train_full_batch

__all__ = [
    "rand_train_test_idx",
    "accuracy",
    "TrainConfig",
    "Trainer",
    "train_full_batch",
]
