"""Per-segment object API (configuration and introspection layer).

Counterpart of ``continuum_robot_tpu/models/segments.py``: ``LinearSegment``,
``NonlinearSegment``, ``SegmentFactory`` and ``segments_from_dataframe``.
The compute path never iterates these objects; ``models/assembly.py``
evaluates all elements in one batched call of the same element functions.
"""

from __future__ import annotations

from typing import Callable, List, Union

import numpy as np

from . import elements
from .abstractions import (
    ElementType,
    ISegment,
    ISegmentFactory,
    Properties,
    create_properties_from_dataframe,
)


class LinearSegment(ISegment):
    """Linear Euler-Bernoulli frame element (6x6 constant K and M)."""

    def __init__(self, properties: Properties):
        super().__init__(properties)
        if properties.get_element_type() != ElementType.LINEAR:
            raise ValueError(
                f"LinearSegment requires LINEAR element type, got {properties.element_type}"
            )

    def get_mass_matrix(self) -> np.ndarray:
        p = self.properties
        return elements.consistent_mass_matrix(p.length, p.density, p.cross_area)

    def get_stiffness_func(self) -> Union[np.ndarray, Callable]:
        p = self.properties
        return elements.linear_stiffness_matrix(
            p.length, p.elastic_modulus, p.moment_inertia, p.cross_area
        )

    def get_element_type(self) -> ElementType:
        return ElementType.LINEAR


class NonlinearSegment(ISegment):
    """Geometric-nonlinear (von Kármán) element: state-dependent force."""

    def __init__(self, properties: Properties):
        super().__init__(properties)
        if properties.get_element_type() != ElementType.NONLINEAR:
            raise ValueError(
                f"NonlinearSegment requires NONLINEAR element type, got {properties.element_type}"
            )

    def get_mass_matrix(self) -> np.ndarray:
        p = self.properties
        return elements.consistent_mass_matrix(p.length, p.density, p.cross_area)

    def get_stiffness_func(self) -> Union[np.ndarray, Callable]:
        p = self.properties

        def stiffness_func(x) -> np.ndarray:
            return np.asarray(
                elements.nonlinear_internal_force(
                    np.asarray(x),
                    p.length,
                    p.elastic_modulus,
                    p.moment_inertia,
                    p.cross_area,
                )
            )

        return stiffness_func

    def get_element_type(self) -> ElementType:
        return ElementType.NONLINEAR


class SegmentFactory(ISegmentFactory):
    """Dispatch on ``Properties.element_type``."""

    def create_segment(self, properties: Properties) -> ISegment:
        element_type = self.detect_element_type(properties)
        if element_type == ElementType.LINEAR:
            return LinearSegment(properties)
        if element_type == ElementType.NONLINEAR:
            return NonlinearSegment(properties)
        raise ValueError(f"Unknown element type: {element_type}")

    def detect_element_type(self, properties: Properties) -> ElementType:
        return properties.get_element_type()


def segments_from_dataframe(df) -> List[ISegment]:
    """Build the per-segment object list for a parameter table."""
    factory = SegmentFactory()
    return [
        factory.create_segment(create_properties_from_dataframe(df, i))
        for i in range(len(df))
    ]
