from .builder import ROLLUP_META_KEY, RollupConfig, build_rollup  # noqa: F401
from .query import match_rollup, try_rollup_execute  # noqa: F401
