# Synthetic stand-ins for the paper's datasets, BCPNN unit coding and the
# batch pipeline (numpy copies of repro.data's, so both packages draw the
# same data; ShardedBatcher gives each rank its rows).
from repro_torch.data.synthetic import ImageDataset, make_image_classes, mnist_like, stl10_like
from repro_torch.data.coding import complementary_code, onehot_code
from repro_torch.data.pipeline import ShardedBatcher, epoch_batches, lm_batches

__all__ = [
    "ImageDataset", "make_image_classes", "mnist_like", "stl10_like",
    "complementary_code", "onehot_code",
    "ShardedBatcher", "epoch_batches", "lm_batches",
]
