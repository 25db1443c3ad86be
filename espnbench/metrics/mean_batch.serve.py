"""Mean requests a batch the server dispatched in the window (the
batcher's count, which ``ServeStats.batch_sizes`` holds too)."""


def read(record):
    if record["traffic"]["loop"] != "open":
        return None
    sizes = record["window"].batch_sizes
    return sum(sizes) / len(sizes) if sizes else None
