"""The share of the traced segment, in %, in which no kernel, copy or set
runs on the card: 100 x (1 - union of the device intervals / wall time)."""


def read(spec, reading):
    busy, window = reading.busy_and_window()
    return 100.0 * (1.0 - busy / window)
