"""refresh_encrypt_ms.gpt2: Host ms per GPT-2 LayerNorm in the refreshes'
re-encoding, host sampling and device encryption (the port's
``refresh.encode`` span and the ``encrypt.sample`` and ``encrypt.device``
spans of ``Encryptor.encrypt_symmetric``, inside its ``refresh`` spans; the
last ``encrypt.device`` of each ends with the card synchronized)."""

from fhe_bench import recorded


def read(run):
    return recorded.host_ms_under_per_request(run, "refresh",
                                              "refresh.encode", "encrypt.")
