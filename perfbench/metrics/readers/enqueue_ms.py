"""Host ms until the program's entry call returns, mean over the main
window's batches or steps, from the harness's own clock around the call."""


def read(spec, reading):
    return sum(reading.enqueue_ms) / len(reading.enqueue_ms) if reading.enqueue_ms else None
