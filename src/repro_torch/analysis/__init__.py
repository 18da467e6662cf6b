# The analytical half of the paper, as one typed surface (§6: "filtering
# stored data by dimensions and by range" while the simulation runs):
#   * repro_torch.analysis.query     — typed statements + fluent builder; the
#     ONLY place SAVIME mini-language text is assembled;
#   * AnalysisSession          — reader-side twin of TransferSession:
#     owns the connection, typed QueryResults, retry/reconnect, stats,
#     and watch() live subscriptions (subscribe/notify wire ops);
#   * repro_torch.analysis.analyzers — @register_analyzer registry of streaming
#     analyses consuming QueryResults and emitting typed Summaries.
# See DESIGN.md §8 for the API and the migration table from raw query
# strings.
from repro_torch.analysis.query import (  # noqa: F401
    AGG_OPS, Aggregate, CreateTar, DropTar, LoadSubtar, QueryBuilder,
    Select, Statement, Window, tar,
)
from repro_torch.analysis.session import (  # noqa: F401
    AnalysisSession, AnalysisStats, QueryResult, SubscriptionClosed,
    SubtarEvent, Subscription,
)
from repro_torch.analysis import analyzers  # noqa: F401
from repro_torch.analysis.analyzers import (  # noqa: F401
    Analyzer, Summary, UnknownAnalyzerError, register_analyzer,
)
