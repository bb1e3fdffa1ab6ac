"""Global planners: PRM + Theta*, D* Lite, potential fields
(counterpart: ``tpunav/planning/__init__.py``). The grid labelling and the
potential field are batched tensor ops on the device; the graph searches
(A*/Theta*, D* Lite) and the roadmap's geometry stay on the host."""

from .utilities import min_dist_segment_point, signed_min_dist  # noqa: F401
from .grid_map import PlanningGrid, FREE, OBSTACLE, INFLATED  # noqa: F401
from .potential_field import PotentialField, PotentialFieldConfig  # noqa: F401
from .prm import RoadMap, theta_star  # noqa: F401
from .dstar import DStarLite  # noqa: F401
from .world import load_obstacle_map, REFERENCE_MAP  # noqa: F401
