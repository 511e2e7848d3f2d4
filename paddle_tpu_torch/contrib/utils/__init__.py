from . import hdfs_utils, lookup_table_utils  # noqa: F401
from .hdfs_utils import HDFSClient, multi_download, multi_upload  # noqa: F401
from .lookup_table_utils import (  # noqa: F401
    convert_dist_to_sparse_program, load_persistables_for_increment,
    load_persistables_for_inference)
