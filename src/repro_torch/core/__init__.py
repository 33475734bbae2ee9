"""repro_torch.core — network storage, queries, traversal, sampling,
analysis, files, mutation and durability in PyTorch."""

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
    DEFAULT_COMPACT_RATIO,
    LayerOneMode,
    LayerTwoMode,
    add_edges,
    compact_layer,
    delete_edges,
    has_overlay,
    layer_overlay_ratio,
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
from .analysis import (
    bfs_distances,
    connected_components,
    degree_centrality,
    degree_distribution,
    density,
    projected_degree,
    shortest_path_length,
)
from .processing import (
    dichotomize,
    filter_edges,
    induced_subnetwork,
    subgraph_layer,
    symmetrize,
)
from .projection import project_two_mode, projection_nbytes
from .overlay import DeltaOverlay, overlay_ratio, overlay_update
from .request import (
    QueryRequest,
    QueryResult,
    assert_results_equal,
    merge_filter_kwargs,
    run_queries,
    run_query,
)
from .traversal import (
    components_batched,
    ego_batch,
    khop_neighborhood,
    khop_records,
    random_walk_batch,
)
from .sharded import ShardedNetwork, shard_network
from .walks import ego_sample, neighborhood_sample, random_walk
from .memory import memory_report, peak_rss, resident_rss
from .temporal import TemporalNetwork
from .convert import network_from_arrays
from .io import (
    TruncatedFileError,
    export_layer_tsv,
    import_layer_tsv,
    load_attrs_tsv,
    load_network,
    save_network,
)
from .wal import (
    WALCorruptHeaderError,
    WALReplayError,
    WALWriteError,
    WriteAheadLog,
    apply_op,
    replay,
)
from .snapshot import (
    DurableStore,
    RecoveryInfo,
    SnapshotMissingError,
    recover,
    write_snapshot,
)
