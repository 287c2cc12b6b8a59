"""City-scale scene partitioning: octree chunking over packed keys with
exact halo exchange (the reference's `repro.partition`, on the host in
numpy, with no device code of its own).

One huge point cloud becomes a stream of bucket-sized, spatially-local
chunks that flow through the serve stack as ordinary scenes; the plan
stitches per-chunk predictions back into scene order with halo rows
dropped, and chunked output equals the monolithic output on every
interior point.

  * `octree`  — recursive packed-key range splitting of the level-0
    ranking order into budget-bounded chunks (on the 62-bit key trie, no
    sort beyond the one ranking pass);
  * `halo`    — per-chunk needed-input sets from the kernel receptive
    field across the stride pyramid (binary searches against each
    level's packed keys, host-side);
  * `plan`    — `PartitionPlan`: chunks onto the `BucketLadder`, through
    `ServeScheduler`/`ServeRouter` submit/flush/take, gather + stitch.
"""

from repro_torch.partition.halo import HaloSpec  # noqa: F401
from repro_torch.partition.octree import split_ranges  # noqa: F401
from repro_torch.partition.plan import (  # noqa: F401
    PartitionPlan, PartitionPolicy, plan_partition)
