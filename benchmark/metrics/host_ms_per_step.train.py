"""Mean host work of the compiled step's call (generators reseeded, the
optimizer's scalars written, the batch copied into the graph's buffers,
the replay launched, the counts), ms: the call's span in the profiled
sub-window less the time its thread spent inside CUDA runtime calls,
where a device-bound loop blocks until the device has drained its queue
(the traced run prints those calls' seconds on standard error)."""

from benchmark.metrics._read import span_work_ms


def read(records):
    return span_work_ms(records, "step_call")
