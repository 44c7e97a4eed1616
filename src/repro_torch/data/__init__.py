# Synthetic stand-ins for the paper's datasets and BCPNN unit coding
# (numpy-only copies of repro.data's, so both packages draw the same data).
from repro_torch.data.synthetic import ImageDataset, make_image_classes, mnist_like, stl10_like
from repro_torch.data.coding import complementary_code, onehot_code

__all__ = [
    "ImageDataset", "make_image_classes", "mnist_like", "stl10_like",
    "complementary_code", "onehot_code",
]
