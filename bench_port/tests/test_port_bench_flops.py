"""The yardstick's counts against the hand counts of ``flops.py``."""

import json

import pytest

from bench_port import flops
from bench_port.cell import HERE


def _config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name, macs, train", [
    ("dense", 5_767_168, 30_408_704),
    ("deep_wide", 55_967_744, 302_252_032),
])
def test_counts_match_the_hand_counts(name, macs, train):
    config = _config(name)
    assert flops.forward_macs_per_frame(config) == macs
    assert flops.train_flops_per_frame(config) == train
    first_in, first_out = flops.layers(config)[0]
    assert train == 2 * (3 * macs - first_in * first_out)


@pytest.mark.parametrize("name, params", [
    ("dense", 5_772_800), ("deep_wide", 55_987_712)])
def test_param_counts(name, params):
    assert flops.param_count(_config(name)) == params


@pytest.mark.parametrize("tier", sorted(flops.TIERS))
def test_least_step_time_bounds_the_model_flops(tier):
    """The least time is at least the model's FLOPs at the tier's pass
    count over its peak, so the roofline share never exceeds what the
    arithmetic allows."""
    config = _config("dense")
    batch = config["batch_size"]
    peak, passes, _ = flops.TIERS[tier]
    model = flops.train_flops_per_frame(config) * batch * passes / peak
    assert flops.least_step_seconds(config, batch, tier) >= model
    products = flops.step_products(config, batch, tier)
    assert len(products) == 3 * len(flops.layers(config)) - 1
    assert sum(f for _, f, _ in products) == \
        flops.train_flops_per_frame(config) * batch * passes
