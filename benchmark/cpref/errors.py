"""Proof errors (parity: `curdleproofs/src/errors.rs:7-11`)."""


class ProofError(Exception):
    """Raised when a proof fails to verify."""


class VerificationError(ProofError):
    """Proof verification failed."""
