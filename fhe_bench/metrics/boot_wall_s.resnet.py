"""boot_wall_s.resnet: Host seconds per ``CkksBackend.bootstrap`` call of a
ResNet block, the card synchronized at both edges."""

from fhe_bench import readers


def read(run):
    return readers.seconds_per_call(run, "boot_s", "boots")
