"""Model layer: types, element matrices, assembly, forces, beam facades and
the modal engine."""

from .abstractions import (
    AbstractForce,
    AbstractInputHandler,
    AssemblyContext,
    BoundaryConditionType,
    ElementType,
    IBeam,
    ISegment,
    ISegmentFactory,
    Properties,
    create_properties_from_dataframe,
)
from .config import BCInfo, BeamArrays, ForceParams, beam_arrays_from_dataframe
from .dynamic_beam_model import DynamicEulerBernoulliBeam
from .euler_bernoulli_beam import EulerBernoulliBeam
from .forces import (
    FluidDragForce,
    FluidDynamicsParams,
    ForceRegistry,
    GravityForce,
    InputRegistry,
)
from .segments import LinearSegment, NonlinearSegment, SegmentFactory

__all__ = [
    "AbstractForce",
    "AbstractInputHandler",
    "AssemblyContext",
    "BCInfo",
    "BeamArrays",
    "BoundaryConditionType",
    "DynamicEulerBernoulliBeam",
    "ElementType",
    "EulerBernoulliBeam",
    "FluidDragForce",
    "FluidDynamicsParams",
    "ForceParams",
    "ForceRegistry",
    "GravityForce",
    "IBeam",
    "ISegment",
    "ISegmentFactory",
    "InputRegistry",
    "LinearSegment",
    "NonlinearSegment",
    "Properties",
    "SegmentFactory",
    "beam_arrays_from_dataframe",
    "create_properties_from_dataframe",
]
