"""One run of a cell: set-up, the measured window, the comparison.

``Run(cell, seed, device)``:

1. ``setup()``: the seeded circuit through the program's front end
   (``TensorNetworkSimulation.from_circuit``: simplify), the cell's frozen
   plan through ``load_plan`` (plan load and scheme compile, timed as
   ``scheme_s``), the width the program picks
   (``metrics.dividing_slice_width``), ``prepare`` at that width (staging
   and the runner), and two batches: the first captures the CUDA graphs,
   the second replays them warm.  With a traffic's ``share`` a batch sums
   the share's slice ids alone (``share_call``), at the width halved to
   the share (``traffic.share_width``).
2. ``window(seconds, trace)``: batches back to back, one caller, until
   ``seconds`` have passed; each batch is one call of the runner (every
   slice group replayed and summed) and, for amplitude traffic, the
   amplitudes copied to the host; for state traffic the state stays on
   the device, timed to a synchronize, and a seeded sample of it is read
   back after the batch's clock stops.  With ``trace`` the window lasts
   at most ``TRACE_SECONDS`` and runs under ``torch.profiler``.
3. ``release()`` frees the program's state, ``check(limits)`` runs the
   reference and compares (``compare.py``).  The configuration's
   ``reference`` names it: "statevector" (the default,
   ``reference/statevector.py``; over a share, the states with the sliced
   wire segments projected onto each block of its ids), or "network"
   (``reference/network.py``, the contraction along the cell's plan,
   which never holds the state), at each batch's bitstrings, or a sample
   of them drawn from the seed (``traffic.reference_sample``).
"""

import gc
import sys
import time

import numpy as np
import torch

from tnbench import compare
from tnbench import roofline
from tnbench import traffic
from tnbench import devtrace as trace_mod

TRACE_SECONDS = 5.0
REFERENCES = ("statevector", "network")


def share_call(sim, ids, slice_batch, device, dtype, precision, eager=False):
    """``sim.prepare``'s call over the slice ids ``ids`` alone: the body of
    the program's ``prepare`` (its span, the fold and staging, the sliced
    runner), with ``ids`` passed to the runner as one replica of the
    program's slice mesh passes its range
    (``parallel.run_sliced_contraction``); ``prepare`` itself takes no
    slice ids."""
    from artensor_tpu_torch.ops.field import make_field
    from artensor_tpu_torch.runtime import executor, tracing
    from artensor_tpu_torch.simulation import require_device

    device = require_device(device)
    with tracing.span("prepare"):
        field, run_steps, arrays, out_shape, execute, _ = sim._staged(
            device, make_field(dtype, precision))
        run = executor.make_sliced_runner(
            execute, run_steps, sim.slicing_axes, len(sim.slicing_bonds),
            out_shape, field, slice_batch=slice_batch, eager=eager)
    call = lambda: run(arrays, ids)   # noqa: E731
    call.stats = run.stats
    call.capture = lambda: run.capture(arrays, ids)
    return call


class Run:
    def __init__(self, cell, seed, device="cuda", precision=None):
        self.cell, self.seed, self.device = cell, seed, device
        self.precision = precision or cell.config["precision"]
        self.state = cell.traffic["requests"] == "state"
        self.reference_kind = cell.config.get("reference", "statevector")
        if self.reference_kind not in REFERENCES:
            raise ValueError(f"unknown reference {self.reference_kind!r}")
        if self.state and self.reference_kind == "network":
            raise ValueError("a state traffic is checked against the state "
                             "vector; the network reference computes "
                             "amplitudes of bitstrings")
        self.times, self.outputs, self.trace = [], [], None
        self.scheme_s = self.capture_s = self.setup_s = None
        self.peak_bytes = None

    # -- set-up --------------------------------------------------------------
    def setup(self):
        from artensor_tpu_torch import TensorNetworkSimulation
        from artensor_tpu_torch.runtime import executor, metrics

        cuda = self.device == "cuda"
        if cuda:
            from artensor_tpu_torch import kernels

            kernels.load()
        self.n, self.layers = traffic.circuit(self.cell.config, self.seed)
        bits = traffic.bitstrings(self.cell.traffic, self.n)
        dtype = {"complex64": np.complex64}[self.cell.config["dtype"]]
        sim = TensorNetworkSimulation.from_circuit((self.n, self.layers),
                                                   bits)
        t0 = time.perf_counter()
        sim.load_plan(self.cell.plan_path)
        self.scheme_s = time.perf_counter() - t0
        run_steps, _ = executor.precompute_static_steps(
            sim.steps, [sim.tensors[i] for i in range(len(sim.tensors))],
            sim.slicing_axes)
        k = len(sim.slicing_bonds)
        self.slicing_bonds = list(sim.slicing_bonds)
        self.slice_ids = traffic.share(self.cell.traffic, k)
        self.width = traffic.share_width(
            metrics.dividing_slice_width(run_steps, k, sim.slicing_axes),
            self.slice_ids)
        self.slice_floor_s = roofline.scheme_roofline_seconds(run_steps)
        self.roofline_s = traffic.slices_run(k, self.slice_ids) * \
            self.slice_floor_s
        if self.state:
            self.amps_per_batch = traffic.amps_per_batch(2 ** self.n, k,
                                                         self.slice_ids)
            self.axis_qubits = [int(str(b).split("-")[1])
                                for b in sim.output_bonds]
            self.sample_idx = traffic.state_sample(self.cell.traffic, self.n,
                                                   self.seed)
            self._sample_dev = torch.as_tensor(traffic.axis_index(
                self.sample_idx, self.axis_qubits, self.n), device=self.device)
        else:
            self.amps_per_batch = traffic.amps_per_batch(
                len(sim.bitstrings_sorted), k, self.slice_ids)
            self.bitstrings = list(sim.bitstrings_sorted)
            if self.reference_kind == "network":
                self.sample = traffic.reference_sample(
                    len(self.bitstrings), self.seed)
        ids = self.slice_ids
        share = "" if ids is None else \
            f" (slice ids {ids.start}-{ids.stop - 1} a batch)"
        print(f"tnbench: {self.cell.name} seed {self.seed}: {len(sim.steps)} "
              f"steps, {2 ** k} slices{share}, slice_batch {self.width}, "
              f"{self.amps_per_batch} amplitudes a batch, precision "
              f"{self.precision}", flush=True)
        self.sim, self.dtype = sim, dtype
        self.prepare(self.precision)

    def prepare(self, precision):
        """The runner at the cell's width in ``precision``, warm: its first
        batch captures the graphs, its second replays them."""
        self.call = self.last = None
        self.precision = precision
        self.call = self.make_call()
        self.batch()
        self.batch()
        self.outputs.clear()
        self.capture_s = self.call.stats["capture_s"]
        if self.device == "cuda":
            torch.cuda.synchronize()

    def make_call(self, eager=False):
        """The program's call of one batch at the cell's width and
        precision: ``prepare``'s, or over a share ``share_call``'s."""
        kw = dict(slice_batch=self.width, device=self.device,
                  dtype=self.dtype, precision=self.precision)
        if eager:
            kw["eager"] = True
        if self.slice_ids is None:
            return self.sim.prepare(**kw)
        return share_call(self.sim, self.slice_ids, **kw)

    def batch(self):
        """One batch; returns its seconds on the host clock."""
        self.last = None        # the previous state goes before the next
        t0 = time.perf_counter()
        out = self.call()
        if self.state:
            if self.device == "cuda":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            re, im = (c.reshape(-1) for c in self.sim.field.buffers(out))
            self.outputs.append((re[self._sample_dev].cpu().numpy()
                                 + 1j * im[self._sample_dev].cpu().numpy()))
            self.last = (re, im)
        else:
            amps = self.sim.field.unwrap(out).reshape(-1)   # on the host
            dt = time.perf_counter() - t0
            self.outputs.append(amps)
        return dt

    # -- the window ----------------------------------------------------------
    def window(self, seconds, trace=False):
        """Batches back to back for ``seconds`` (host clock, to the end of
        the batch that crosses it).  With ``trace`` on a card the window is
        ``min(seconds, TRACE_SECONDS)`` under ``torch.profiler``, and its
        trace is read after it closes."""
        cuda = self.device == "cuda"
        prof = None
        if trace and cuda:
            from torch.profiler import ProfilerActivity, profile

            seconds = min(seconds, TRACE_SECONDS)
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        try:
            t0 = time.perf_counter()
            while True:
                now = time.perf_counter()
                if self.times and now - t0 >= seconds:
                    break
                self.times.append(self.marked_batch(prof))
            self.window_s = now - t0
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        if prof is not None:
            self.trace = trace_mod.summarize(trace_mod.profiler_events(prof),
                                             self.window_s, len(self.times))
        if cuda:
            self.peak_bytes = torch.cuda.max_memory_allocated()

    def marked_batch(self, prof):
        if prof is None:
            return self.batch()
        from torch.profiler import record_function

        with record_function(trace_mod.HOST_MARK + "batch"):
            return self.batch()

    # -- after the window ----------------------------------------------------
    def release(self):
        """Free the program's state; keep its outputs (for a state, the
        last one)."""
        last = self.last
        self.sim = self.call = self.last = self._sample_dev = None
        gc.collect()
        self.last_state = last
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def reference(self):
        """The reference of this run, on its device: the state of its
        circuit (over a share, the share's part of it), or with the
        network reference the sampled bitstrings' amplitudes."""
        if self.reference_kind == "network":
            from tnbench.reference.network import amplitudes

            return amplitudes(self.n, self.layers, self.cell.plan_path,
                              [self.bitstrings[i] for i in self.sample],
                              self.slice_ids, device=self.device)
        from tnbench.reference.statevector import share_state, state_vector

        if self.slice_ids is None:
            return state_vector(self.n, self.layers, device=self.device)
        return share_state(self.n, self.layers, self.slicing_bonds,
                           self.slice_ids, device=self.device)

    def numbers(self, ref, limits, outputs=None, last_state=None):
        """``(numbers, failed)`` of outputs (default: this run's) against
        the reference ``ref`` (``reference()``'s)."""
        from tnbench.reference.statevector import amplitudes

        outputs = self.outputs if outputs is None else outputs
        if self.reference_kind == "network":
            return compare.amplitude_batches(
                [a[self.sample] for a in outputs], ref, limits)
        if self.state:
            last = self.last_state if last_state is None else last_state
            return compare.state_batches(last, self.axis_qubits, outputs,
                                         ref, self.sample_idx, limits)
        return compare.amplitude_batches(
            outputs, amplitudes(ref, self.bitstrings), limits)

    def check(self, limits):
        """``(correct, compared, failed, reference seconds)``; prints each
        number beside its limit on standard error."""
        t0 = time.perf_counter()
        ref = self.reference()
        numbers, failed = self.numbers(ref, limits)
        del ref
        self.last_state = None
        ref_s = time.perf_counter() - t0
        correct, compared = compare.judge(numbers, failed, limits,
                                          len(self.times))
        for k, c in compared.items():
            print(f"tnbench compare {k} {c['value']!r} limit {c['limit']!r}",
                  file=sys.stderr)
        return correct, compared, failed, ref_s
