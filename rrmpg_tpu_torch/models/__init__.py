"""Model interface classes (API-compatible with ``rrmpg_tpu.models``)."""

from .abcmodel import ABCModel
from .basemodel import BaseModel
from .gr4j import GR4J
from .hbvedu import HBVEdu

__all__ = ['ABCModel', 'BaseModel', 'GR4J', 'HBVEdu']
