"""Host time in `Pipeline.infer_chunks` (the benchmark's `infer_chunks`
span: windowing, staging, uploads and graph replays, which never wait for
the card) per real frame of the window, in ms."""


def read(record):
    frames = record["counts"].get("frames")
    seconds = record["spans"].get("infer_chunks")
    if not frames or seconds is None:
        return None
    return 1e3 * seconds / frames
