"""One process a card: the other ranks of a training cell on more than one
card, and rank 0's hold on them.

Rank 0 is the process of ``run.py`` (``program.TrainRanks``). ``Ranks``
starts ranks 1.. as processes of this module (``python3 -m
benchmark.ranks`` from the checkout's root), one a card, with torchrun's
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT, and
OMP_NUM_THREADS=1 as torchrun sets it), joins their process group itself
through the port's ``maybe_initialize_distributed`` and builds the port's
mesh (``make_mesh``). Each other rank reads its cell, seed, rank 0's
backend flags and the faults open in rank 0 (``faults.py``) from its
standard input, sets up the same
``program.Train`` on its card, and then runs one step for each "step"
line rank 0 writes: rank 0 owns the clock, and every rank runs the same
steps. "trace <n>" profiles n steps and reports the rank's busy time,
window and NCCL kernel time; "memory" reports the card's memory peak;
"end" reports the rank's steps, its time in the step's call and its wait
for step lines, and ends the rank. Replies are JSON lines on the rank's
standard output;
the program's own prints go to its standard error, of which rank 0 keeps
the tail.

A rank that exits before it is told to, or ranks that are not done
within ``LIMIT_S`` seconds of their start besides the window's own
seconds (``extend``), end the run: rank 0 prints
each rank's exit and the tail of its standard error, kills every rank
and exits with ``FAILED`` (its own thread may be waiting in a collective
that will never complete). A rank dies with rank 0 (the kernel's
parent-death signal).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time

import torch

from . import faults

LIMIT_S = 300.0  # from the ranks' start to their end, besides the window: set-up, trace
GROUP_TIMEOUT_S = 120.0  # a collective's, and the rendezvous's
LEAVE_S = 30.0  # rank 0's wait to leave the process group with the others
FAILED = 4
TAIL_LINES = 60
ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NCCL = "collective (NCCL)"  # yardstick.FAMILIES' name for NCCL's kernels


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def replica_gap(model):
    """The largest absolute difference between an element of this rank's
    parameters or floating buffers (the running statistics) and rank 0's.
    Every rank calls it; each gets the answer."""
    import torch.distributed as dist
    tensors = [p.detach() for p in model.parameters()]
    tensors += [b for b in model.buffers() if b.is_floating_point()]
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    gap = (flat - ref).abs().max().reshape(1)
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    return gap.item()


def _backends(values=None):
    """The backend flags this process runs with (TF32 for matmuls and cuDNN,
    oneDNN on the CPU), or, given ``values``, set them."""
    b = torch.backends
    flags = {"matmul_tf32": (b.cuda.matmul, "allow_tf32"), "cudnn_tf32": (b.cudnn, "allow_tf32"),
             "mkldnn": (b.mkldnn, "enabled")}
    if values is None:
        return {k: getattr(obj, attr) for k, (obj, attr) in flags.items()}
    for k, (obj, attr) in flags.items():
        setattr(obj, attr, values[k])


class _Rank:
    """A child rank: its process, its replies and the tail of its
    standard error, each drained by a thread of its own."""

    def __init__(self, rank, env, init):
        self.rank = rank
        self.proc = subprocess.Popen([sys.executable, "-m", "benchmark.ranks", str(os.getpid())],
                                     cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, env=env, text=True, bufsize=1)
        self.replies = queue.Queue()
        self.tail = collections.deque(maxlen=TAIL_LINES)
        self.drains = [threading.Thread(target=self._drain, args=(stream, sink), daemon=True)
                       for stream, sink in ((self.proc.stdout, self._reply),
                                            (self.proc.stderr, self.tail.append))]
        for t in self.drains:
            t.start()
        self.send(json.dumps(init))

    @staticmethod
    def _drain(stream, sink):
        for line in stream:
            sink(line.rstrip("\n"))

    def _reply(self, line):
        self.replies.put(json.loads(line))

    def send(self, line):
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()


class Ranks:
    """Ranks 1..chips-1 of ``cell`` on the cards after ``device`` (or on
    the CPU, over gloo), and this process joined to them as rank 0:
    ``mesh`` is the port's. ``ready`` once every rank has set up;
    ``signal_s`` is the time rank 0 has spent writing step lines."""

    def __init__(self, cell, seed, device):
        from damvsnet_tpu_torch.parallel import make_mesh, maybe_initialize_distributed
        world = cell["chips"]
        port = _free_port()
        self.ready = self.ended = self.closing = False
        self.lock = threading.Lock()  # over ``closing``: the watch's and close's
        self.signal_s = 0.0
        self.saved = ({k: os.environ.get(k) for k in ENV}, torch.get_num_threads())
        init = {"cell": cell, "seed": seed, "device": device.type, "faults": faults.active(),
                "backends": _backends()}
        init = json.loads(json.dumps(init, default=str))
        env = {**os.environ, "WORLD_SIZE": str(world), "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1"}
        self.children = [_Rank(r, {**env, "RANK": str(r), "LOCAL_RANK": str(r)}, init)
                         for r in range(1, world)]
        self.deadline = time.monotonic() + LIMIT_S
        threading.Thread(target=self._watch, daemon=True).start()
        os.environ.update({k: env[k] for k in ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")},
                          RANK="0", LOCAL_RANK="0")
        torch.set_num_threads(1)
        try:
            maybe_initialize_distributed(None, device if device.type == "cpu" else None,
                                         timeout=GROUP_TIMEOUT_S)
            self.mesh = make_mesh()
        except BaseException:
            self.close()
            raise

    # -- rank 0's side ---------------------------------------------------
    def _watch(self):
        while not self.closing:
            for c in self.children:
                rc = c.proc.poll()
                if rc is not None and not (rc == 0 and self.ended):
                    self._abort(f"rank {c.rank} exited with {rc}")
            if time.monotonic() > self.deadline:
                self._abort(f"the ranks were not done within {LIMIT_S:g} s")
            time.sleep(0.2)

    def _abort(self, why):
        with self.lock:
            if self.closing:
                return
            self.closing = True
        print(f"ranks: {why}; ending every rank", file=sys.stderr, flush=True)
        self._kill()
        self._print_tails(every=True)
        os._exit(FAILED)

    def _kill(self):
        for c in self.children:
            if c.proc.poll() is None:
                c.proc.kill()
        for c in self.children:
            c.proc.wait()
            for t in c.drains:
                t.join(timeout=2)

    def _print_tails(self, every=False):
        for c in self.children:
            if every or c.proc.returncode != 0:
                print(f"--- rank {c.rank}, exit {c.proc.returncode}, the tail of its "
                      "standard error:\n" + "\n".join(c.tail), file=sys.stderr, flush=True)

    def extend(self, seconds):
        """Give the ranks ``seconds`` more before the watch ends them (the
        window's)."""
        self.deadline += seconds

    def command(self, line):
        self.ended = self.ended or line == "end"  # before a rank can act on it
        t0 = time.perf_counter()
        for c in self.children:
            c.send(line)
        if line == "step":
            self.signal_s += time.perf_counter() - t0

    def replies(self, kind):
        """Each other rank's next reply, which must be of ``kind``. Waits;
        the watch ends the run if a rank dies or the limit passes."""
        out = []
        for c in self.children:
            reply = c.replies.get()
            if reply.get("reply") != kind:
                raise RuntimeError(f"rank {c.rank} replied {reply}, not {kind!r}")
            out.append(reply)
        return out

    def wait_ready(self):
        self.replies("ready")
        self.ready = True

    def close(self):
        """End every rank: those that were told to end are waited for;
        the others get a few seconds to end by themselves (a rank that
        failed), then are killed, and every rank's tail is printed. Then
        leave the process group. Returns the ranks' "end" replies, or None
        where they were not told to end."""
        import torch.distributed as dist
        ends = None
        if self.ready and not self.ended:
            self.command("end")
            ends = self.replies("end")
        clean = self.ended
        if dist.is_initialized() and (clean or dist.get_backend() == "gloo"):
            # with the other ranks, which leave it after their "end" reply:
            # NCCL's leaving waits for theirs, and with a dead peer it may
            # never return, so it gets a thread and a limit
            leave = threading.Thread(target=dist.destroy_process_group, daemon=True)
            leave.start()
            leave.join(timeout=LEAVE_S)
        with self.lock:
            self.closing = True
        deadline = time.monotonic() + (60 if clean else 5)
        try:
            for c in self.children:
                c.proc.wait(timeout=max(deadline - time.monotonic(), 0.01))
        except subprocess.TimeoutExpired:
            clean = False
        self._kill()
        clean = clean and all(c.proc.returncode == 0 for c in self.children)
        self._print_tails(every=not clean)
        for c in self.children:
            for stream in (c.proc.stdin, c.proc.stdout, c.proc.stderr):
                with contextlib.suppress(OSError):
                    stream.close()
        env, threads = self.saved
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        torch.set_num_threads(threads)
        return ends


# -- the other ranks' side ---------------------------------------------
def _die_with_parent(parent):
    """SIGKILL this process when its parent ends (Linux's PR_SET_PDEATHSIG)."""
    if sys.platform.startswith("linux"):
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl.argtypes = [ctypes.c_int, ctypes.c_ulong]
        libc.prctl.restype = ctypes.c_int
        libc.prctl(1, signal.SIGKILL)
    if os.getppid() != parent:
        sys.exit("ranks: rank 0 ended before this rank started")


def child_main(parent):
    _die_with_parent(parent)
    import torch.distributed as dist

    from benchmark import program, trace
    from damvsnet_tpu_torch.parallel import (local_device, make_mesh,
                                             maybe_initialize_distributed)
    init = json.loads(sys.stdin.readline())
    replies = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)  # what the program prints goes to standard error

    def reply(kind, **values):
        replies.write(json.dumps({"reply": kind, **values}) + "\n")

    _backends(init["backends"])  # rank 0's
    with contextlib.ExitStack() as stack:
        for name in init["faults"]:
            stack.enter_context(faults.FAULTS[name]())
        device = local_device("cpu" if init["device"] == "cpu" else None)
        maybe_initialize_distributed(None, device if device.type == "cpu" else None,
                                     timeout=GROUP_TIMEOUT_S)
        session = program.Train(init["cell"], init["seed"], device, mesh=make_mesh())
        session.pool = None  # this rank steps on its rows, in ``feed``
        replica_gap(session.state.model)
        reply("ready")
        wait = call = 0.0
        steps, t0 = 0, time.perf_counter()
        for line in sys.stdin:
            cmd, *arg = line.split()
            if cmd == "step":
                wait += time.perf_counter() - t0
                call += session.unit()[0]
                steps += 1
            elif cmd == "trace":
                t = trace.reduce(trace.profile(session.unit, int(arg[0])), int(arg[0]))
                reply("trace", busy_s=t["busy_s"], window_s=t["window_s"],
                      nccl_s=t["families"].get(NCCL, 0.0))
            elif cmd == "memory":
                reply("memory", memory_peak_bytes=session.memory_peak_bytes())
            elif cmd == "end":
                reply("end", units=session.n, steps=steps, wait_s=wait, dispatch_s=call)
                break
            t0 = time.perf_counter()
        else:
            sys.exit("ranks: rank 0 closed this rank's input before its end")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(child_main(int(sys.argv[1])))
