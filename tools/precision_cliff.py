#!/usr/bin/env python3
"""The paper's precision sweep (Fig. 3) on the port, from its own init.

    python3 tools/precision_cliff.py [--device cuda|cpu]

Fits the configuration of ``tests/test_network_e2e.py``'s
``TestPrecisionCliff`` (mnist_like, 64 features complementary-coded,
16x16 hidden, fan_in 32, lam 0.02, gain 4, 4096 rows, 6 hidden + 6 readout
epochs, B = 128) once per datapath format, from the port's own
``torch.Generator`` init (the tests start from the JAX package's), and
prints one JSON line of accuracies per format.  It runs on the card
unless ``--device cpu`` asks for the CPU (about 15 s there); the device is
printed beside the numbers.  ``chip_smoke.py`` runs :func:`sweep` on the
card.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (  # noqa: E402
    DenseLayer, ExecutionConfig, Network, StructuralPlasticityLayer, UnitLayout, onehot_layout,
)
from repro_torch.data import complementary_code, mnist_like  # noqa: E402

FORMATS = ("fp32", "bf28", "bf24", "bf20", "bf16", "bf15", "bf14")


def sweep(device="cuda", formats=FORMATS) -> dict:
    """Accuracy of one fit per datapath format on ``device``."""
    ds = mnist_like(n_train=4096, n_test=512, n_features=64, seed=0)
    x, layout = complementary_code(ds.x_train)
    xt, _ = complementary_code(ds.x_test)
    net = Network(seed=0)
    net.add(StructuralPlasticityLayer(layout, UnitLayout(16, 16), fan_in=32, lam=0.02,
                                      init_jitter=1.0, gain=4.0))
    net.add(DenseLayer(UnitLayout(16, 16), onehot_layout(10), lam=0.02))
    accs = {}
    for name in formats:
        compiled = net.compile(ExecutionConfig(device=device, precision=name))
        compiled.fit((x, ds.y_train), epochs_hidden=6, epochs_readout=6, batch_size=128)
        accs[name] = compiled.evaluate((xt, ds.y_test))
    return accs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = parser.parse_args().device
    print(json.dumps({"device": device, "accuracy": sweep(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
