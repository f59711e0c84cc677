"""Model interface classes (API-compatible with ``rrmpg_tpu.models``)."""

from .abcmodel import ABCModel
from .basemodel import BaseModel
from .cemaneige import Cemaneige
from .cemaneigegr4j import CemaneigeGR4J
from .cemaneigegr4jice import CemaneigeGR4JIce
from .cemaneigehystgr4j import CemaneigeHystGR4J
from .cemaneigehystgr4jice import CemaneigeHystGR4JIce
from .gr4j import GR4J
from .hbvedu import HBVEdu
from .states import (
    ABCState,
    CemaneigeHystState,
    CemaneigeState,
    GR4JState,
    HBVEduState,
    SnowGR4JState,
    repair_state,
)

__all__ = ['ABCModel', 'BaseModel', 'Cemaneige', 'CemaneigeGR4J',
           'CemaneigeGR4JIce', 'CemaneigeHystGR4J', 'CemaneigeHystGR4JIce',
           'GR4J', 'HBVEdu', 'ABCState', 'CemaneigeHystState',
           'CemaneigeState', 'GR4JState', 'HBVEduState', 'SnowGR4JState',
           'repair_state']
