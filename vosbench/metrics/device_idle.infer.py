"""The share of the traced window in which no kernel, copy or fill ran on
the device, in %: 100 x (1 - union of device intervals / window)."""


def read(record):
    dev = record.get("device")
    if not dev or not dev["window_s"] or not dev["busy_s"]:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
