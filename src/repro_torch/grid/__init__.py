"""The paper's control plane as a runtime service (``DataGridService``)."""
