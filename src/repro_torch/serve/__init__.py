"""Deadline-aware co-execution serving subsystem.

Open-loop request workloads (workload.py) dispatched across heterogeneous
model replicas by the paper's scheduler stack (server.py), with a shared
accounting path (stats.py).  Replicas (replica.py) run the port's model
on a card, or on the host when the caller asks for ``device="cpu"``.  The
JAX package's discrete-event twin (core/simulate.py::simulate_serving) is
a later slice of the port.
"""
from repro_torch.serve.admission import AdmissionConfig, EdfAdmission
from repro_torch.serve.replica import Replica
from repro_torch.serve.server import CoexecServer, ServeOutcome, ServerConfig
from repro_torch.serve.stats import ServeStats, percentile, summarize
from repro_torch.serve.workload import (ARRIVALS, Request, RequestQueue,
                                  TraceWorkload, bursty_arrivals,
                                  make_requests, poisson_arrivals,
                                  record_trace, trace_arrivals)

__all__ = [
    "ARRIVALS", "AdmissionConfig", "CoexecServer", "EdfAdmission",
    "Replica", "Request", "RequestQueue", "ServeOutcome", "ServeStats",
    "ServerConfig", "TraceWorkload", "bursty_arrivals", "make_requests",
    "percentile", "poisson_arrivals", "record_trace", "summarize",
    "trace_arrivals",
]
