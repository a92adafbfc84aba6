"""Faults planted in the program, for the check that ``correct`` catches
them (``calibrate.py`` on the card, ``tests/`` on the CPU).  Each patches
the program's modules in this process while the context is open; the
files are never touched.

* ``unchanged``: a step that returns its state unchanged (Adam counts the
  update and moves nothing);
* ``half_batch``: half of each batch left out, the loss's mean taken over
  the rest;
* ``bias_twice``: the decoder's answer altered where it is produced, its
  last layer's bias added twice (and so its gradient doubled);
* ``same_order``: every epoch trains in the first epoch's order (a fault
  that shows only in the window, after set-up's epoch).

A cell on one card has no exchange between cards to leave out.
"""

from __future__ import annotations

import contextlib
import dataclasses
from functools import partial

FAULTS = ("unchanged", "half_batch", "bias_twice", "same_order")


def _doubled_last_bias(params):
    params = dict(params)
    if "fc4" in params:
        params["fc4"] = dict(params["fc4"], b=2 * params["fc4"]["b"])
    else:
        params["dec"] = list(params["dec"])
        last = params["dec"][-1]
        params["dec"][-1] = dict(last, b=2 * last["b"])
    return params


def _bias_twice(model):
    decode = model.decode

    def faulty(params, z, **kw):
        return decode(_doubled_last_bias(params), z, **kw)

    fn = decode
    while isinstance(fn, partial):
        fn = fn.func
    if hasattr(fn, "high_passes"):
        faulty.high_passes = fn.high_passes
    return dataclasses.replace(model, decode=faulty)


@contextlib.contextmanager
def planted(fault: str):
    from rawaudiovae_kelsey_tpu_torch.parallel import resident
    from rawaudiovae_kelsey_tpu_torch.train.optim import Adam

    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    build, update = resident.build_train_step, Adam.update
    perm_seed = resident.perm_seed

    def counting_only(self, state, grads):
        state.count += 1

    def broken_build(model, cfg, optimizer=None, noise=None, mesh=None):
        if fault == "bias_twice":
            return build(_bias_twice(model), cfg, optimizer, noise, mesh)
        step = build(model, cfg, optimizer, noise, mesh)

        def half(state, batch, weights=None):
            return step(state, batch[: batch.shape[0] // 2])

        return half

    if fault == "unchanged":
        Adam.update = counting_only
    elif fault == "same_order":
        resident.perm_seed = lambda seed, epoch: perm_seed(seed, 0)
    else:
        resident.build_train_step = broken_build
    try:
        yield
    finally:
        Adam.update = update
        resident.build_train_step = build
        resident.perm_seed = perm_seed
