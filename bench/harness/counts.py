"""Operations and bytes of the work a cell asks for, from shapes alone.

They measure the work the algorithm needs, whatever implements it: each
input byte is counted read once and each output byte written once (f32), and
a product through the receptive-field mask counts only the pairs the mask
keeps, as a sparse product counts what its inputs need.  The learning cycle
counts every (i, j) pair, since structural plasticity reads all of C_ij.

A launch is a tuple ``(kernel, shape)``.  A shape counts itself: its
``cost()`` gives its ``(flops, bytes)`` and its ``precision`` names the rate
its operations run at (``"f32"`` or a key of :attr:`Peaks.rates`), so a kind of
cell defines the shapes of its own launches in its own file.  :func:`bound_s`
gives a launch's least time on a chip.
"""
from __future__ import annotations

from types import MappingProxyType
from typing import Dict, Iterable, Mapping, NamedTuple, Tuple

F32 = 4  # bytes


class Forward(NamedTuple):
    """``s = x @ (w o mask) + b`` for ``rows`` rows of ``features`` inputs
    into ``units`` outputs, each output reading ``kept`` inputs; ``mask``
    is the (pre HCU, post HCU) receptive-field mask's size, 0 without one."""

    rows: int
    features: int
    units: int
    kept: int
    mask: int = 0
    precision = "f32"

    def cost(self) -> Tuple[float, float]:
        r, f, u, k, m = self
        flops = 2.0 * r * k * u + r * u  # kept multiply-adds, the bias
        nbytes = F32 * (r * f + k * u + u + m + r * u)
        return flops, nbytes


class Softmax(NamedTuple):
    """Softmax within each hypercolumn of ``units`` outputs, ``rows`` rows."""

    rows: int
    units: int
    precision = "f32"

    def cost(self) -> Tuple[float, float]:
        r, u = self
        return 4.0 * r * u, F32 * 2.0 * r * u  # max, exp, sum, divide


class Update(NamedTuple):
    """One learning cycle of ``rows`` rows: the batch means, the EWMA of
    c_i (``pre``), c_j (``post``) and C_ij, the weights and the bias;
    ``mask`` as for :class:`Forward`."""

    rows: int
    pre: int
    post: int
    mask: int = 0
    precision = "f32"

    def cost(self) -> Tuple[float, float]:
        r, i, j, m = self
        pairs = float(i) * j
        # The a_i^T a_j product's multiply-adds, the means of a_i and a_j,
        # and per pair one multiply-add of the EWMA and one subtraction of
        # the weight (the logarithms are not counted).
        flops = 2.0 * r * pairs + r * (i + j) + 3.0 * pairs
        read = r * i + r * j + i + j + pairs + m
        written = i + j + pairs + pairs + j  # c_i, c_j, C_ij, w, b
        return flops, F32 * float(read + written)


def cost(shape) -> Tuple[float, float]:
    """(operations, bytes) of one launch's work, as its shape counts them."""
    return shape.cost()


class Peaks(NamedTuple):
    flops: float  # f32 operations a second, outside the tensor cores
    bytes: float  # device memory bytes a second
    rates: Mapping[str, float] = MappingProxyType({})  # operations a second, other precisions

    def rate(self, precision: str) -> float:
        """Operations a second at ``precision``: ``flops`` for f32."""
        if precision == "f32":
            return self.flops
        if precision not in self.rates:
            raise KeyError(f"no published rate for {precision!r} operations")
        return self.rates[precision]


# NVIDIA H100 SXM5 80GB data sheet, at its 700 W limit, dense rates (no
# sparsity): 67 TFLOP/s f32 outside the tensor cores (the port keeps TF32
# off), on the tensor cores 494.7 TF32, 989.4 bf16 and fp16 and 1,978.9 fp8;
# 3.35 TB/s of HBM3.
H100 = Peaks(67e12, 3.35e12, MappingProxyType(
    {"tf32": 494.7e12, "bf16": 989.4e12, "fp16": 989.4e12, "fp8": 1978.9e12}))
H100_NAME = "H100 80GB HBM3"  # in the name torch.cuda.get_device_name gives


def peaks_for(kind: str) -> Peaks:
    """The peaks of the card named ``kind``: the H100 SXM's, the only card
    the benchmark's rooflines and mfu are counted against."""
    if H100_NAME not in kind:
        raise SystemExit(f"no published peaks for {kind!r}: the benchmark counts its rooflines "
                         f"and mfu against the {H100_NAME}")
    return H100


def bound_s(shape, peaks: Peaks) -> float:
    """The least time the chip could take: operations over the peak of the
    launch's own precision or bytes over the bandwidth, whichever is larger."""
    flops, nbytes = cost(shape)
    return max(flops / peaks.rate(shape.precision), nbytes / peaks.bytes)


def totals(launches: Iterable[Tuple[str, object]], peaks: Peaks) -> Dict[str, Dict[str, float]]:
    """Per kernel: launches, operations, bytes and the summed bound."""
    out: Dict[str, Dict[str, float]] = {}
    for kernel, shape in launches:
        flops, nbytes = cost(shape)
        t = out.setdefault(kernel, dict(launches=0, flops=0.0, bytes=0.0, bound_s=0.0))
        t["launches"] += 1
        t["flops"] += flops
        t["bytes"] += nbytes
        t["bound_s"] += bound_s(shape, peaks)
    return out
