from .scheme import KzgCommitment, KzgOpening, KzgScheme
from .srs import Srs

__all__ = ["KzgCommitment", "KzgOpening", "KzgScheme", "Srs"]
