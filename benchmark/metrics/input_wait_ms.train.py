"""Mean host time a step waits on `next()` of the program's
`DevicePrefetcher`, ms."""

from benchmark.metrics._read import span_ms


def read(records):
    return span_ms(records, "input_wait")
