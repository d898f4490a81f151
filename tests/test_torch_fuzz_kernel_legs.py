"""The kernel legs (8-12) of the port's differential campaign against the JAX
campaign's: at the same ``n`` and seed each gives the JAX leg's counts, the
port on its kernels' plain versions (CPU), the JAX package on its Pallas
kernels in interpret mode (computed once, ``jax_campaign_leg``)."""

import pytest
import torch

from torch_vectors import hold_jax_native, jax_campaign_leg, share_cores_with_workers

from snappy_tpu_torch.tools import fuzz_campaign as fc

share_cores_with_workers()
hold_jax_native()


@pytest.mark.parametrize("leg,n,route", [(8, 30, "flat"), (9, 30, "records"), (10, 2, "flat"),
                                         (11, 2, None), (12, 2, None)])
def test_kernel_leg_gives_the_jax_legs_counts(leg, n, route):
    want = jax_campaign_leg(leg, n)
    got = fc.LEGS[leg](n, torch.device("cpu"))
    assert {k: got[k] for k in want} == want
    if route is not None:
        assert list(got[f"leg{leg}_routes"]) == [route]
