"""refresh_decrypt_ms.gpt2: Host ms per GPT-2 LayerNorm in the refreshes' device
decrypt with its copy to the host and their host CRT decode (the port's
``decrypt.device`` and ``decrypt.decode`` spans of ``Decryptor.decrypt``,
inside its ``refresh`` spans)."""

from fhe_bench import recorded


def read(run):
    return recorded.host_ms_under_per_request(run, "refresh", "decrypt.")
