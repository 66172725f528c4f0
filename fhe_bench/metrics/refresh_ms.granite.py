"""refresh_ms.granite: Host ms in refreshes per Granite 4.0-H mixer core, the
card synchronized at both edges of each."""

from fhe_bench import readers


def read(run):
    return readers.ms_per_request(run, "refresh_s")
