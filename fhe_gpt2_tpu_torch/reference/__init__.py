"""Plain references of the models the port runs: float64 torch, no
polynomial, no Newton iteration, no refresh, nothing of the port."""
