"""refreshes.granite: Decrypt/re-encrypt refreshes (``fake_bootstrap``) per
Granite 4.0-H mixer core."""

from fhe_bench import readers


def read(run):
    return readers.count_per_request(run, "refreshes")
