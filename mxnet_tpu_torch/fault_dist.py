"""fault_dist -- the multi-host fault layer: its device-runtime error
classifier.

Counterpart of ``mxnet_tpu/fault_dist.py``'s ``classify_xla_error`` and
the marker lists it reads (:720-790).  A device runtime reports every
failure as one error type told apart only by message: a reset
connection is worth re-running, an out-of-memory or a corrupted context
re-runs the same doomed program.  The serving engine's transient-decode
retry asks this classifier (``serve.Server.engine_step``).

The port also classifies PyTorch's own device-runtime errors:
``torch.cuda.OutOfMemoryError``, an illegal memory access and a
device-side assert are fatal; an NCCL peer that exited and a reset
connection are transient.  Fatal markers win over transient ones, and
an unknown message stays unclassified (``None``), as in the reference:
never retry a mutation on a guess.

The rest of the reference module (the consensus comm,
``coordinated_call``, ``Generation``, ``Heartbeat``, ``StepLease`` and
the resilient bootstrap) waits for ROADMAP queue 4.
"""
from __future__ import annotations

__all__ = ["TRANSIENT_XLA_MARKERS", "FATAL_XLA_MARKERS",
           "TRANSIENT_TORCH_MARKERS", "FATAL_TORCH_MARKERS",
           "classify_xla_error"]

#: message fragments of a transient transport failure (retry-worthy),
#: the reference's list
TRANSIENT_XLA_MARKERS = (
    "UNAVAILABLE",             # grpc/DCN channel dropped
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "Connection reset",
    "connection reset",
    "Connection refused",
    "Connection timed out",
    "Socket closed",
    "Broken pipe",
    "transport is closing",
    "failed to connect",
    "timed out",
    "Timed out",
)
#: fragments that are fatal no matter what else the message says, the
#: reference's list
FATAL_XLA_MARKERS = (
    "RESOURCE_EXHAUSTED",      # OOM -- a retry re-allocates the same bytes
    "Out of memory",
    "out of memory",
    "OOM",
    "INVALID_ARGUMENT",        # program/shape bug
    "FAILED_PRECONDITION",
    "UNIMPLEMENTED",
    "Compilation failure",
    "compilation failure",
    "Mosaic",                  # custom-kernel lowering bug
)
#: PyTorch's transient device-runtime messages: an NCCL peer that went
#: away, a reset socket under the process group
TRANSIENT_TORCH_MARKERS = (
    "remote process exited",
    "ncclRemoteError",
)
#: PyTorch's fatal device-runtime messages: the CUDA context is gone
#: (illegal address, a failed device-side assert) or memory ran out
FATAL_TORCH_MARKERS = (
    "illegal memory access",
    "illegal address",
    "device-side assert",
    "unspecified launch failure",
    "CUBLAS_STATUS_",
)

#: error classes that are a device runtime's, by name (the reference's
#: contract: names, not imports)
_RUNTIME_CLASSES = ("XlaRuntimeError", "JaxRuntimeError", "OutOfMemoryError",
                    "AcceleratorError", "DistError", "DistBackendError",
                    "DistNetworkError")
#: a plain RuntimeError is the device runtime's when its message says so
_RUNTIME_TEXT = ("CUDA error", "NCCL", "CUDA out of memory", "cuDNN error",
                 "CUBLAS_STATUS_")


def _is_runtime_error(e):
    if any(c.__name__ in _RUNTIME_CLASSES for c in type(e).__mro__):
        return True
    return isinstance(e, RuntimeError) and any(
        m in str(e) for m in _RUNTIME_TEXT)


def classify_xla_error(e):
    """``"transient"`` / ``"fatal"`` / ``None`` for a device-runtime
    error (``None``: not one, or a message no marker names -- the
    caller's own classification applies).  Fatal markers win over
    transient ones: an OOM diagnostic that happens to mention a reset
    connection while tearing down must not be retried."""
    if not _is_runtime_error(e):
        return None
    text = str(e)
    if any(m in text for m in FATAL_XLA_MARKERS + FATAL_TORCH_MARKERS):
        return "fatal"
    if any(m in text for m in TRANSIENT_XLA_MARKERS
           + TRANSIENT_TORCH_MARKERS):
        return "transient"
    return None


#: the reference module's public names that wait for ROADMAP queue 4
_NOT_PORTED = ("initialize", "coordinated_call", "Generation",
               "generation", "Heartbeat", "StepLease", "step_lease",
               "enable_step_heartbeat", "disable_step_heartbeat",
               "enable_step_lease", "disable_step_lease", "LocalComm",
               "InProcessComm", "FileComm", "CoordServiceComm",
               "default_comm", "set_default_comm", "MaintenancePoller",
               "watch_maintenance")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            "fault_dist.%s is not ported yet (ROADMAP queue 4: the "
            "consensus comm, coordinated_call, Generation, Heartbeat, "
            "StepLease and the bootstrap)" % name)
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
