"""Faults planted in the program underneath a run: what the output check
has to catch.  The CPU tests plant each at the tiny size;
`calibrate.py --faults` reads each on the card at the cell's size, and the
limits are set against those readings.  Each is a context manager that
patches the program and puts it back.

  unchanged    a step that returns its state unchanged (the update left
               out);
  half_loss    half of the batch left out of the loss, the mean taken over
               the rest, with the forward over the whole batch;
  stale_half   the second half of each step's views left over from the
               step before, as a copy into the graph's static input that
               stops halfway would leave them;
  rolled       (eval) each batch's logits altered where they are produced;
  padded_flip  (eval) the real rows of a padded batch scored on other
               views (each view mirrored), the padding rows untouched."""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _train():
    return importlib.import_module("gvcnn_tf_tpu_torch.train")


def unchanged():
    return _patched(_train().Optimizer, "apply", lambda self, grads: None)


def half_loss():
    train = _train()
    ce = train.cross_entropy

    def half(logits, labels, *args, **kwargs):
        n = len(labels) // 2
        return ce(logits[:n], labels[:n], *args, **kwargs)

    return _patched(train, "cross_entropy", half)


def stale_half():
    train = _train()
    step = train.device_step
    prev = {}

    def stale(state, batch, config):
        views = batch["views"]
        n = len(views) // 2
        if "views" not in prev:
            prev["views"] = views.clone()
        mixed = torch.cat([views[:n], prev["views"][n:]])
        prev["views"].copy_(views)
        return step(state, dict(batch, views=mixed), config)

    return _patched(train, "device_step", stale)


def _eval():
    return importlib.import_module("gvcnn_tf_tpu_torch.eval")


def rolled():
    ev = _eval()
    scores = ev._scores

    def altered(model, views, labels):
        hits, logits = scores(model, views, labels)
        return hits, logits.roll(1, dims=-1)

    return _patched(ev, "_scores", altered)


def padded_flip():
    ev = _eval()
    make = ev.DevicePrefetcher

    def flipped(batches, *args, **kwargs):
        def alter():
            for b in batches:
                v = np.asarray(b["views"])
                pad = ~v.reshape(len(v), -1).any(1)
                if pad.any():            # the real rows of a padded batch
                    v = v.copy()
                    v[~pad] = v[~pad][..., ::-1, :]
                yield dict(b, views=v)
        return make(alter(), *args, **kwargs)

    return _patched(ev, "DevicePrefetcher", flipped)


FAULTS = {"unchanged": unchanged, "half_loss": half_loss,
          "stale_half": stale_half, "rolled": rolled,
          "padded_flip": padded_flip}
