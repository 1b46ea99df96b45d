"""Device kernels (copies and fills not counted) in the traced part of the
window per real frame completed there."""

COPIES = ("Memcpy", "Memset")


def read(record):
    dev, traced = record.get("device"), record.get("traced")
    if not dev or not traced or not traced.get("frames"):
        return None
    kernels = sum(calls for name, (_, calls) in dev["by_name"].items() if not name.startswith(COPIES))
    return kernels / traced["frames"] if kernels else None
