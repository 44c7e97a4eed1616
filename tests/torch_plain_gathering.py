"""A stand-in for ``masked_matmul``'s gathered launch on the CPU.

The gathered kernel runs only on the card.  Under :func:`plain_gathering`
``masked_matmul.gathers`` says yes to every ``hcu_mask=`` product, and such
a product is the plain product over the expanded mask, counted as a
gathered launch.  For tests of the code around the kernel (the layer step's
choice, the counters, the spans).
"""
import contextlib

import pytest

from repro_torch.kernels import masked_matmul as mk
from repro_torch.kernels import ref


@contextlib.contextmanager
def plain_gathering():
    product = mk.masked_matmul

    def stand_in(x, w, b, mask=None, *, hcu_mask=None, pre_mcu=None, post_mcu=None,
                 fan_in=None, **kw):
        if hcu_mask is None:
            return product(x, w, b, mask=mask, **kw)
        mk.launches += 1
        mk.gathered_launches += 1
        return ref.masked_matmul(x, w, b, ref.unit_mask(hcu_mask, pre_mcu, post_mcu))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mk, "gathers", lambda *args, **kwargs: True)
        mp.setattr(mk, "masked_matmul", stand_in)
        yield
