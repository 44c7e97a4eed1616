# Synthetic stand-ins for the paper's datasets and the LM zoo's token
# stream, BCPNN unit coding and the batch pipeline (numpy copies of
# repro.data's, so both packages draw the same data; ShardedBatcher gives
# each rank its rows).
from repro_torch.data.synthetic import (
    ImageDataset, make_image_classes, mnist_like, stl10_like, token_stream,
)
from repro_torch.data.coding import complementary_code, onehot_code
from repro_torch.data.pipeline import ShardedBatcher, epoch_batches, lm_batches

__all__ = [
    "ImageDataset", "make_image_classes", "mnist_like", "stl10_like", "token_stream",
    "complementary_code", "onehot_code",
    "ShardedBatcher", "epoch_batches", "lm_batches",
]
