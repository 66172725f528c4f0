"""encode_ms.resnet: Host ms in mask encodings per ResNet block."""

from fhe_bench import readers


def read(run):
    return readers.ms_per_request(run, "encode_s")
