"""Host-side plots of previews and closed-loop telemetry (matplotlib)."""

from .plot import LEG_COLORS, plot_preview, plot_telemetry  # noqa: F401
