"""Faults planted under the timed path, for the readings that set the
limits (``calibrate.py``) and for the tests that see ``correct`` come out
false or a run end. Each is a context manager that patches the port while
it is open; a training cell's other ranks (``ranks.py``) open the faults
that are open in rank 0 (``active``).

  stage2_answer   serving: each answer's final depth and confidence are
                  stage 2's, upsampled (stage 3's work is lost)
  half_batch      training: the step sees the first half of its global
                  batch and takes its mean over those rows (in one process
                  its batch is cut; across ranks, the ranks take the first
                  half's rows in turn, the port's ``batch_rows``)
  frozen_state    training: the step returns its state unchanged (the
                  parameters, running statistics and optimizer as before)
  skip_allreduce  training across ranks: the last rank keeps its own
                  gradient where DDP's all-reduce gives the mean (it takes
                  part in the all-reduce, so no rank waits)
  rank_raises     training across ranks: the last rank's step raises
"""
from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np

FAULTS = {}
_OPEN = []  # the names of the faults open in this process, in order


def _fault(make):
    """Register ``make`` (a generator function) as a fault under its name."""
    cm = contextlib.contextmanager(make)

    @contextlib.contextmanager
    def opened():
        with cm():
            _OPEN.append(make.__name__)
            try:
                yield
            finally:
                _OPEN.remove(make.__name__)

    FAULTS[make.__name__] = opened
    return opened


def active():
    """The names of the faults open in this process."""
    return list(_OPEN)


def _upsample2(a):
    return np.repeat(np.repeat(a, 2, axis=-2), 2, axis=-1)


@_fault
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


def _across_ranks(mesh):
    return mesh is not None and mesh.data > 1


def _wrap_step(wrap):
    """Patch ``make_train_step`` so that ``wrap(step, mesh)`` stands for
    each step it builds."""
    from damvsnet_tpu_torch.train import loop
    real = loop.make_train_step

    def make(*args, **kwargs):
        return wrap(real(*args, **kwargs), kwargs.get("mesh"))

    return mock.patch.object(loop, "make_train_step", make)


@_fault
def half_batch():
    from damvsnet_tpu_torch.parallel import mesh as port_mesh
    real_rows = port_mesh.batch_rows

    def first_half(batch_size, rank, world, grad_accum=1):
        return [i % (batch_size // 2) for i in real_rows(batch_size, rank, world, grad_accum)]

    def wrap(step, mesh):
        if _across_ranks(mesh):
            return step  # the rows stand in

        def half(state, batch):
            def cut(x):
                return {k: cut(v) for k, v in x.items()} if isinstance(x, dict) \
                    else x[:x.shape[0] // 2]
            return step(state, cut(batch))
        return half

    with _wrap_step(wrap), mock.patch.object(port_mesh, "batch_rows", first_half):
        yield


@_fault
def frozen_state():
    def wrap(step, mesh):
        def frozen(state, batch):
            saved = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
            metrics = step(state, batch)
            state.model.load_state_dict(saved)
            state.optimizer.state.clear()
            return metrics
        return frozen

    with _wrap_step(wrap):
        yield


def _last_rank(group):
    import torch.distributed as dist
    return dist.get_rank(group) == dist.get_world_size(group) - 1


@_fault
def skip_allreduce():
    import torch.distributed as dist
    from damvsnet_tpu_torch.train import loop
    real = loop.DistributedDataParallel

    def own_gradient(group, bucket):
        buf = bucket.buffer()
        own = buf.clone()
        fut = dist.all_reduce(buf.div_(dist.get_world_size(group)), group=group,
                              async_op=True).get_future()
        return fut.then(lambda _: own)

    def make(module, *args, **kwargs):
        ddp = real(module, *args, **kwargs)
        group = kwargs.get("process_group") or dist.group.WORLD
        if _last_rank(group):
            ddp.register_comm_hook(group, own_gradient)
        return ddp

    with mock.patch.object(loop, "DistributedDataParallel", make):
        yield


@_fault
def rank_raises():
    def wrap(step, mesh):
        if not (_across_ranks(mesh) and _last_rank(mesh.data_group)):
            return step

        def raising(state, batch):
            raise RuntimeError("rank_raises: this rank's step fails")
        return raising

    with _wrap_step(wrap):
        yield
