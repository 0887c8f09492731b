"""One run of a cell: set-up, the measured window, the comparison.

``Run(cell, seed, device)``:

1. ``setup()``: the seeded circuit through the program's front end
   (``TensorNetworkSimulation.from_circuit``: simplify), the cell's frozen
   plan through ``load_plan`` (plan load and scheme compile, timed as
   ``scheme_s``), the width the program picks
   (``metrics.dividing_slice_width``), ``prepare`` at that width (staging
   and the runner), and two batches: the first captures the CUDA graphs,
   the second replays them warm.
2. ``window(seconds, trace)``: batches back to back, one caller, until
   ``seconds`` have passed; each batch is one call of the runner (every
   slice group replayed and summed) and, for amplitude traffic, the
   amplitudes copied to the host; for state traffic the state stays on
   the device, timed to a synchronize, and a seeded sample of it is read
   back after the batch's clock stops.  With ``trace`` the window lasts
   at most ``TRACE_SECONDS`` and runs under ``torch.profiler``.
3. ``release()`` frees the program's state, ``check(limits)`` runs the
   reference and compares (``compare.py``).
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


class Run:
    def __init__(self, cell, seed, device="cuda", precision=None):
        self.cell, self.seed, self.device = cell, seed, device
        self.precision = precision or cell.config["precision"]
        self.state = cell.traffic["requests"] == "state"
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
        self.width = metrics.dividing_slice_width(run_steps, k,
                                                  sim.slicing_axes)
        self.roofline_s = 2 ** k * roofline.scheme_roofline_seconds(run_steps)
        if self.state:
            self.amps_per_batch = 2 ** self.n
            self.axis_qubits = [int(str(b).split("-")[1])
                                for b in sim.output_bonds]
            self.sample_idx = traffic.state_sample(self.cell.traffic, self.n,
                                                   self.seed)
            self._sample_dev = torch.as_tensor(traffic.axis_index(
                self.sample_idx, self.axis_qubits, self.n), device=self.device)
        else:
            self.amps_per_batch = len(sim.bitstrings_sorted)
            self.bitstrings = list(sim.bitstrings_sorted)
        print(f"tnbench: {self.cell.name} seed {self.seed}: {len(sim.steps)} "
              f"steps, {2 ** k} slices, slice_batch {self.width}, "
              f"{self.amps_per_batch} amplitudes a batch, precision "
              f"{self.precision}", flush=True)
        self.sim, self.dtype = sim, dtype
        self.prepare(self.precision)

    def prepare(self, precision):
        """The runner at the cell's width in ``precision``, warm: its first
        batch captures the graphs, its second replays them."""
        self.call = self.last = None
        self.precision = precision
        self.call = self.sim.prepare(slice_batch=self.width,
                                     device=self.device, dtype=self.dtype,
                                     precision=precision)
        self.batch()
        self.batch()
        self.outputs.clear()
        self.capture_s = self.call.stats["capture_s"]
        if self.device == "cuda":
            torch.cuda.synchronize()

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
        """The reference's state of this run's circuit, on its device."""
        from tnbench.reference.statevector import state_vector

        return state_vector(self.n, self.layers, device=self.device)

    def numbers(self, psi, limits, outputs=None, last_state=None):
        """``(numbers, failed)`` of outputs (default: this run's) against
        the reference state ``psi``."""
        from tnbench.reference.statevector import amplitudes

        outputs = self.outputs if outputs is None else outputs
        if self.state:
            last = self.last_state if last_state is None else last_state
            return compare.state_batches(last, self.axis_qubits, outputs,
                                         psi, self.sample_idx, limits)
        return compare.amplitude_batches(
            outputs, amplitudes(psi, self.bitstrings), limits)

    def check(self, limits):
        """``(correct, compared, failed, reference seconds)``; prints each
        number beside its limit on standard error."""
        t0 = time.perf_counter()
        psi = self.reference()
        numbers, failed = self.numbers(psi, limits)
        del psi
        self.last_state = None
        ref_s = time.perf_counter() - t0
        correct, compared = compare.judge(numbers, failed, limits,
                                          len(self.times))
        for k, c in compared.items():
            print(f"tnbench compare {k} {c['value']!r} limit {c['limit']!r}",
                  file=sys.stderr)
        return correct, compared, failed, ref_s
