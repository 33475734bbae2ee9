"""repro_torch.core — network storage and the point-query path in PyTorch."""

from .csr import (
    CSR,
    DEFAULT_POLICY,
    POLICY_INT32,
    SENTINEL,
    DtypePolicy,
    csr_from_coo,
    csr_from_coo_chunks,
    csr_transpose,
    resolve_device,
)
from .layers import (
    LayerOneMode,
    LayerTwoMode,
    one_mode_from_edge_chunks,
    one_mode_from_edges,
    two_mode_empty,
    two_mode_from_membership_chunks,
    two_mode_from_memberships,
)
from .network import Network, create_network
from .nodeset import (
    AttributeStore,
    NodeSelection,
    Nodeset,
    create_nodeset,
    node_filter_mask,
)
from .generators import (
    barabasi_albert,
    erdos_renyi,
    random_two_mode,
    watts_strogatz,
)
from .projection import project_two_mode
from .traversal import (
    components_batched,
    ego_batch,
    khop_neighborhood,
    khop_records,
)
from .convert import network_from_arrays
