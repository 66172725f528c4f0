"""boots.resnet: ``CkksBackend.bootstrap`` calls per ResNet block."""

from fhe_bench import readers


def read(run):
    return readers.count_per_request(run, "boots")
