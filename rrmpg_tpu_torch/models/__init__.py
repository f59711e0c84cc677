"""Model interface classes (API-compatible with ``rrmpg_tpu.models``)."""

from .basemodel import BaseModel
from .gr4j import GR4J

__all__ = ['BaseModel', 'GR4J']
