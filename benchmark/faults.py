"""Faults planted under the timed path, for the readings that set the
limits (``calibrate.py``) and for the test that sees ``correct`` come out
false. Each is a context manager that patches the port while it is open.

  stage2_answer   serving: each answer's final depth and confidence are
                  stage 2's, upsampled (stage 3's work is lost)
  half_batch      training: the step sees the first half of its batch and
                  takes its mean over those rows
  frozen_state    training: the step returns its state unchanged (the
                  parameters, running statistics and optimizer as before)
"""
from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np


def _upsample2(a):
    return np.repeat(np.repeat(a, 2, axis=-2), 2, axis=-1)


@contextlib.contextmanager
def stage2_answer():
    from damvsnet_tpu_torch.infer import runner
    real = runner.DepthRunner.__call__

    def call(self, batch):
        out = real(self, batch)
        out["depth"] = _upsample2(out["stage2"]["depth"])
        out["photometric_confidence"] = _upsample2(out["stage2"]["photometric_confidence"])
        return out

    with mock.patch.object(runner.DepthRunner, "__call__", call):
        yield


def _wrap_step(wrap):
    from damvsnet_tpu_torch.train import loop
    real = loop.make_train_step

    def make(*args, **kwargs):
        return wrap(real(*args, **kwargs))

    return mock.patch.object(loop, "make_train_step", make)


@contextlib.contextmanager
def half_batch():
    def wrap(step):
        def half(state, batch):
            def cut(x):
                return {k: cut(v) for k, v in x.items()} if isinstance(x, dict) \
                    else x[:x.shape[0] // 2]
            return step(state, cut(batch))
        return half

    with _wrap_step(wrap):
        yield


@contextlib.contextmanager
def frozen_state():
    def wrap(step):
        def frozen(state, batch):
            saved = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
            metrics = step(state, batch)
            state.model.load_state_dict(saved)
            state.optimizer.state.clear()
            return metrics
        return frozen

    with _wrap_step(wrap):
        yield


FAULTS = {"stage2_answer": stage2_answer, "half_batch": half_batch,
          "frozen_state": frozen_state}
