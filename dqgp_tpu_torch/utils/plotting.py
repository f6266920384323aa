"""Plot suite — a copy of ``dqgp_tpu/utils/plotting.py``: PNG artifacts
matching the reference's plot families (main.py:294-431, 684-1309,
1738-1925; real_world_datasets.py:586-790): dataset scatter, agent data
distribution, predictions with uncertainty, convergence histories. All
savers, headless-safe (Agg backend), with the same file names.

matplotlib is imported when a function draws, never when the module is
imported: the card's host has none, and a run there passes ``--no-plot``.
Without it every function raises an ``ImportError`` that says so."""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np


def pyplot():
    """matplotlib.pyplot on the Agg backend, or an ImportError naming
    ``--no-plot``."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "plots need matplotlib, which is not installed: pass --no-plot "
            "to run without them") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, save_plot: bool, output_dir: str, name: str,
          dpi: int = 300) -> Optional[str]:
    """dpi=300 matches the reference's savefig calls (main.py:1306, 1922;
    real_world_datasets.py:738). Filenames here are deterministic (the
    reference timestamps them — a documented improvement for testability)."""
    plt = pyplot()
    path = None
    if save_plot:
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.join(output_dir, name)
        fig.savefig(path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return path


def _config_panel(ax, config: Optional[Dict], nlpd_info: Optional[Dict] = None):
    """Monospace configuration text panel (main.py:1817-1833, 1900-1907)."""
    ax.axis("off")
    if not config and not nlpd_info:
        return
    lines = [f"{k}: {v}" for k, v in (config or {}).items()]
    if nlpd_info:
        lines += [f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                  for k, v in nlpd_info.items()]
    ax.text(0.05, 0.95, "\n".join(lines), transform=ax.transAxes, fontsize=8,
            verticalalignment="top", fontfamily="monospace",
            bbox=dict(boxstyle="round", facecolor="lightgray", alpha=0.8))
    ax.set_title("Configuration", fontsize=10, fontweight="bold")


def plot_dataset(X, Y, title="Quantum GP Data", save_plot=True, output_dir="plots",
                 train_indices=None, test_indices=None) -> Optional[str]:
    """1D scatter / 2D 3-D scatter / >=3D pairwise projections (main.py:294-431)."""
    plt = pyplot()
    d = X.shape[1]
    if d == 1:
        fig = plt.figure(figsize=(9, 5))
        if train_indices is not None and test_indices is not None:
            plt.scatter(X[train_indices, 0], Y[train_indices], s=18, c="tab:blue", label="Training")
            plt.scatter(X[test_indices, 0], Y[test_indices], s=18, c="tab:red", marker="s", label="Test")
            plt.legend()
        else:
            plt.scatter(X[:, 0], Y, s=14, alpha=0.7)
        plt.xlabel("X"); plt.ylabel("Y"); plt.title(title); plt.grid(True)
    elif d == 2:
        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(111, projection="3d")
        if train_indices is not None and test_indices is not None:
            ax.scatter(X[train_indices, 0], X[train_indices, 1], Y[train_indices],
                       c="tab:blue", s=14, label="Training")
            ax.scatter(X[test_indices, 0], X[test_indices, 1], Y[test_indices],
                       c="tab:red", s=14, marker="s", label="Test")
            ax.legend()
        else:
            ax.scatter(X[:, 0], X[:, 1], Y, c=Y, cmap="viridis", s=12)
        ax.set_xlabel("X1"); ax.set_ylabel("X2"); ax.set_zlabel("Y")
        ax.set_title(title)
    else:
        # Pairwise projections; with a train/test split they are colored by
        # split (blue circles / red squares), otherwise by Y with colorbars —
        # the reference's 3D and >3D branches (main.py:334-431).
        n_plots = min(6, d * (d - 1) // 2)
        cols = 3
        rows = (n_plots + cols - 1) // cols
        fig, axes = plt.subplots(rows, cols, figsize=(15, 5 * rows), squeeze=False)
        k = 0
        for i in range(d):
            for j in range(i + 1, d):
                if k >= n_plots:
                    break
                ax = axes[k // cols][k % cols]
                if train_indices is not None and test_indices is not None:
                    ax.scatter(X[train_indices, i], X[train_indices, j],
                               c="blue", s=30, alpha=0.7, marker="o",
                               label="Training")
                    ax.scatter(X[test_indices, i], X[test_indices, j],
                               c="red", s=30, alpha=0.7, marker="s",
                               label="Test")
                    if k == 0:
                        ax.legend()
                    ax.set_title(f"X{i+1} vs X{j+1}")
                else:
                    sc = ax.scatter(X[:, i], X[:, j], c=Y, cmap="viridis",
                                    s=20, alpha=0.7)
                    plt.colorbar(sc, ax=ax)
                    ax.set_title(f"X{i+1} vs X{j+1} (colored by Y)")
                ax.set_xlabel(f"X{i+1}"); ax.set_ylabel(f"X{j+1}")
                ax.grid(True, alpha=0.3)
                k += 1
            if k >= n_plots:
                break
        for idx in range(k, rows * cols):
            axes[idx // cols][idx % cols].set_visible(False)
        fig.suptitle(f"{title} ({d}D input)")
    return _save(fig, save_plot, output_dir, "dataset.png")


def _coverage_map(splits, x1b, x2b, n_grid=25, threshold=0.15):
    """How many agents have data within ``threshold`` of each grid point
    (main.py:814-838's per-point loop, vectorized)."""
    gx = np.linspace(x1b[0], x1b[1], n_grid)
    gy = np.linspace(x2b[0], x2b[1], n_grid)
    G = np.stack(np.meshgrid(gx, gy, indexing="ij"), -1).reshape(-1, 2)
    cov = np.zeros(G.shape[0])
    for Xa, _ in splits:
        d2 = ((G[:, None, :] - Xa[None, :, :2]) ** 2).sum(-1)
        cov += (d2.min(axis=1) < threshold**2)
    return cov.reshape(n_grid, n_grid)


def _overlap_matrix(splits, chunk: int = 2048, max_rows: int = 1500):
    """Min inter-agent point distances (main.py:846-863, vectorized).

    Chunked over the first agent's rows so the transient difference tensor
    stays bounded, and symmetric (min distance is direction-free), so each
    pair is computed once. Shards beyond ``max_rows`` are deterministically
    subsampled — the panel is a partition-quality visual, and the exact
    pairwise sweep is O(A^2 * N_i * N_j), minutes of host NumPy at
    scale-out sizes (64 agents x thousands of rows)."""
    n = len(splits)
    Xs = []
    for Xa, _ in splits:
        if len(Xa) > max_rows:
            sel = np.random.RandomState(0).choice(len(Xa), max_rows, replace=False)
            Xa = Xa[sel]
        Xs.append(Xa)
    M = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            Xi, Xj = Xs[i], Xs[j]
            best = np.inf
            for s in range(0, len(Xi), chunk):
                d2 = ((Xi[s:s + chunk, None, :] - Xj[None, :, :]) ** 2).sum(-1)
                best = min(best, float(d2.min()))
            M[i, j] = M[j, i] = np.sqrt(best)
    return M


def _agent_densities(splits):
    """samples / convex-hull area, bounding-box fallback (main.py:875-893)."""
    out = []
    for Xa, _ in splits:
        if len(Xa) > 2:
            try:
                from scipy.spatial import ConvexHull

                area = ConvexHull(Xa).volume
            except Exception:
                area = float(np.prod(Xa.max(axis=0) - Xa.min(axis=0)))
            out.append(len(Xa) / area if area > 0 else float(len(Xa)))
        else:
            out.append(float(len(Xa)))
    return out


def _grid_region_panel(ax, n_agents, colors, x1b, x2b):
    """Regular-grid agent-region rectangles, or the k-d note
    (main.py:761-800)."""
    plt = pyplot()
    k = int(round(np.sqrt(n_agents)))
    if k * k == n_agents:
        e1 = np.linspace(x1b[0], x1b[1], k + 1)
        e2 = np.linspace(x2b[0], x2b[1], k + 1)
        for e in e1:
            ax.axvline(e, color="black", linestyle="--", alpha=0.5)
        for e in e2:
            ax.axhline(e, color="black", linestyle="--", alpha=0.5)
        for a in range(n_agents):
            # match _regular_grid_split_numpy's digit order (X1 cell = a//k,
            # X2 cell = a%k for 2D). The reference's own panel draws the
            # TRANSPOSED cell (main.py:777-779 vs 567-575) so its labels
            # contradict its scatter for k>=2 — a bug, consciously diverged.
            i, j = a // k, a % k
            ax.add_patch(plt.Rectangle(
                (e1[i], e2[j]), e1[i + 1] - e1[i], e2[j + 1] - e2[j],
                facecolor=colors[a], alpha=0.3, edgecolor="black", linewidth=1))
            ax.text((e1[i] + e1[i + 1]) / 2, (e2[j] + e2[j + 1]) / 2,
                    f"A{a + 1}", ha="center", va="center",
                    fontweight="bold", fontsize=10)
        ax.set_title(f"Agent Regions\nRegular Grid: {k}×{k}",
                     fontsize=12, fontweight="bold")
    else:
        ax.text(0.5, 0.5, "K-d Tree Partitioning\n(Irregular boundaries)",
                ha="center", va="center", transform=ax.transAxes, fontsize=12)
    ax.set_xlabel("X1"); ax.set_ylabel("X2")
    ax.set_xlim(x1b); ax.set_ylim(x2b); ax.grid(True, alpha=0.3)


def plot_agent_data_distribution(agent_data_splits, title="Agent Data Distribution",
                                 save_plot=True, output_dir="plots") -> Optional[str]:
    """Per-agent shard analysis, panel-for-panel with the reference
    (main.py:684-1309): for 2D inputs, six panels (input-space partitioning
    with grid boundaries, 3D outputs by agent, agent-region map, spatial
    coverage heatmap with data overlay, agent min-distance overlap matrix,
    per-agent density bars) plus a companion analysis figure (partitioning
    statistics + KDE density heatmap, saved as
    ``agent_distribution_analysis.png``). 1D keeps the reference's labeled
    scatter; >2D draws pairwise projections colored by agent."""
    plt = pyplot()
    splits = [(np.asarray(Xa), np.asarray(Ya)) for Xa, Ya in agent_data_splits]
    n_agents = len(splits)
    d = splits[0][0].shape[1]
    colors = plt.cm.Set3(np.linspace(0, 1, n_agents))
    n_total = sum(len(Xa) for Xa, _ in splits)

    if d == 1:
        fig = plt.figure(figsize=(10, 6))
        for i, (Xa, Ya) in enumerate(splits):
            plt.scatter(Xa[:, 0], Ya, alpha=0.7, s=20, color=colors[i],
                        label=f"Agent {i + 1} ({len(Xa)} samples)")
        plt.xlabel("X"); plt.ylabel("Y"); plt.title(title)
        plt.legend(); plt.grid(True)
        return _save(fig, save_plot, output_dir, "agent_distribution.png")

    if d != 2:
        n_plots = min(6, d * (d - 1) // 2)
        cols = 3
        rows = (n_plots + cols - 1) // cols
        fig, axes = plt.subplots(rows, cols, figsize=(15, 5 * rows), squeeze=False)
        k = 0
        for i in range(d):
            for j in range(i + 1, d):
                if k >= n_plots:
                    break
                ax = axes[k // cols][k % cols]
                for a, (Xa, _) in enumerate(splits):
                    ax.scatter(Xa[:, i], Xa[:, j], s=14, color=colors[a], alpha=0.7)
                ax.set_xlabel(f"X{i + 1}"); ax.set_ylabel(f"X{j + 1}")
                ax.set_title(f"X{i + 1} vs X{j + 1} (colored by Agent)")
                k += 1
            if k >= n_plots:
                break
        for idx in range(k, rows * cols):
            axes[idx // cols][idx % cols].set_visible(False)
        fig.suptitle(f"{title} ({d}D Input)")
        return _save(fig, save_plot, output_dir, "agent_distribution.png")

    # ---- 2D: full analysis suite --------------------------------------
    all_X = np.vstack([Xa for Xa, _ in splits])
    x1b = [all_X[:, 0].min(), all_X[:, 0].max()]
    x2b = [all_X[:, 1].min(), all_X[:, 1].max()]
    fig = plt.figure(figsize=(18, 12))

    ax1 = fig.add_subplot(231)
    for i, (Xa, _) in enumerate(splits):
        ax1.scatter(Xa[:, 0], Xa[:, 1], c=[colors[i]], s=30, alpha=0.8,
                    label=f"Agent {i + 1} ({len(Xa)} samples)",
                    edgecolors="black", linewidths=0.3)
    k = int(round(np.sqrt(n_agents)))
    if k * k == n_agents:
        for e in np.linspace(x1b[0], x1b[1], k + 1):
            ax1.axvline(e, color="red", linestyle="--", alpha=0.6, linewidth=1.5)
        for e in np.linspace(x2b[0], x2b[1], k + 1):
            ax1.axhline(e, color="red", linestyle="--", alpha=0.6, linewidth=1.5)
    ax1.set_xlabel("X1"); ax1.set_ylabel("X2")
    ax1.set_title("Input Space Partitioning\n(X1 vs X2)", fontsize=12,
                  fontweight="bold")
    ax1.legend(bbox_to_anchor=(1.05, 1), loc="upper left", fontsize="small")
    ax1.grid(True, alpha=0.3); ax1.set_xlim(x1b); ax1.set_ylim(x2b)

    ax2 = fig.add_subplot(232, projection="3d")
    for i, (Xa, Ya) in enumerate(splits):
        ax2.scatter(Xa[:, 0], Xa[:, 1], Ya, c=[colors[i]], s=25, alpha=0.8,
                    edgecolors="black", linewidths=0.2)
    ax2.set_xlabel("X1"); ax2.set_ylabel("X2"); ax2.set_zlabel("Y")
    ax2.set_title("Output Values by Agent\n(X1, X2, Y)", fontsize=12,
                  fontweight="bold")

    _grid_region_panel(fig.add_subplot(233), n_agents, colors, x1b, x2b)

    ax4 = fig.add_subplot(234)
    cov = _coverage_map(splits, x1b, x2b)
    im = ax4.imshow(cov.T, origin="lower",
                    extent=[x1b[0], x1b[1], x2b[0], x2b[1]],
                    cmap="RdYlGn", alpha=0.7, aspect="auto")
    plt.colorbar(im, ax=ax4, label="Number of agents\nwith nearby data")
    for i, (Xa, _) in enumerate(splits):
        ax4.scatter(Xa[:, 0], Xa[:, 1], c=[colors[i]], s=15, alpha=0.6,
                    edgecolors="black", linewidths=0.1)
    ax4.set_xlabel("X1"); ax4.set_ylabel("X2")
    ax4.set_title("Spatial Coverage Analysis", fontsize=12, fontweight="bold")

    ax5 = fig.add_subplot(235)
    overlap = _overlap_matrix(splits)
    im2 = ax5.imshow(overlap, cmap="viridis")
    ax5.set_xlabel("Agent ID"); ax5.set_ylabel("Agent ID")
    ax5.set_title("Agent Overlap Matrix\n(Min distances)", fontsize=12,
                  fontweight="bold")
    ax5.set_xticks(range(n_agents)); ax5.set_yticks(range(n_agents))
    ax5.set_xticklabels([f"A{i + 1}" for i in range(n_agents)])
    ax5.set_yticklabels([f"A{i + 1}" for i in range(n_agents)])
    plt.colorbar(im2, ax=ax5, label="Distance")
    if n_agents <= 16:  # past ~16 agents the annotations are unreadable
        for i in range(n_agents):
            for j in range(n_agents):
                if i != j:
                    ax5.text(j, i, f"{overlap[i, j]:.2f}", ha="center",
                             va="center", color="white", fontsize=8)

    ax6 = fig.add_subplot(236)
    densities = _agent_densities(splits)
    bars = ax6.bar(range(n_agents), densities, color=colors[:n_agents],
                   alpha=0.7, edgecolor="black")
    ax6.set_xlabel("Agent ID"); ax6.set_ylabel("Data Density\n(samples/area)")
    ax6.set_title("Data Density per Agent", fontsize=12, fontweight="bold")
    ax6.set_xticks(range(n_agents))
    ax6.set_xticklabels([f"A{i + 1}" for i in range(n_agents)])
    for bar, dens in zip(bars, densities):
        ax6.text(bar.get_x() + bar.get_width() / 2,
                 bar.get_height() + max(densities) * 0.01, f"{dens:.1f}",
                 ha="center", va="bottom", fontsize=9)
    fig.tight_layout()
    path = _save(fig, save_plot, output_dir, "agent_distribution.png")

    # Companion analysis figure (main.py:928-990)
    fig2, (ax_stats, ax_kde) = plt.subplots(1, 2, figsize=(16, 6))
    ax_stats.axis("off")
    ax_stats.set_title("Partitioning Statistics", fontweight="bold", fontsize=14)
    lines = [f"Total Agents: {n_agents}", f"Total Samples: {n_total}",
             "Input Space Bounds:",
             f"  X1: [{x1b[0]:.3f}, {x1b[1]:.3f}]",
             f"  X2: [{x2b[0]:.3f}, {x2b[1]:.3f}]", "",
             "Agent Sample Counts:"]
    lines += [f"  Agent {i + 1}: {len(Xa)} samples "
              f"({len(Xa) / n_total * 100:.1f}%)"
              for i, (Xa, _) in enumerate(splits)]
    ax_stats.text(0.05, 0.95, "\n".join(lines), transform=ax_stats.transAxes,
                  fontsize=11, verticalalignment="top", fontfamily="monospace",
                  bbox=dict(boxstyle="round", facecolor="lightgray", alpha=0.8))
    ax_kde.set_title("Data Point Density Visualization", fontweight="bold",
                     fontsize=14)
    try:
        from scipy.stats import gaussian_kde

        xi = np.linspace(x1b[0], x1b[1], 50)
        yi = np.linspace(x2b[0], x2b[1], 50)
        Xi, Yi = np.meshgrid(xi, yi)
        zi = gaussian_kde(all_X.T)(np.vstack([Xi.ravel(), Yi.ravel()]))
        cf = ax_kde.contourf(Xi, Yi, zi.reshape(Xi.shape), levels=20,
                             cmap="Blues", alpha=0.6)
        plt.colorbar(cf, ax=ax_kde, label="Data Density")
    except Exception:
        pass
    for i, (Xa, _) in enumerate(splits):
        ax_kde.scatter(Xa[:, 0], Xa[:, 1], c=[colors[i]], s=12, alpha=0.6)
    ax_kde.set_xlabel("X1"); ax_kde.set_ylabel("X2")
    _save(fig2, save_plot, output_dir, "agent_distribution_analysis.png")
    return path


def plot_predictions(X_test, Y_true, Y_pred, Y_pred_var=None, X_train=None,
                     Y_train=None, title="Quantum GP Predictions",
                     save_plot=True, output_dir="results",
                     config: Optional[Dict] = None,
                     nlpd_info: Optional[Dict] = None,
                     filename: str = "predictions.png") -> Optional[str]:
    """Prediction plots, panel-for-panel with the reference (main.py:1738-1925):

    * 1D — main axis (training data, true test points, GP prediction line,
      95% and 68% confidence bands) + configuration text panel;
    * 2D — four panels: 3D true values, 3D predictions, 3D residuals on an
      RdBu diverging map, configuration panel;
    * >=3D — prediction-correlation scatter with identity line, residuals
      vs predicted, configuration panel.

    ``filename`` lets callers save the trained and ground-truth-parameter
    versions side by side (the GT-vs-trained harness, main.py:3194-3501).
    """
    plt = pyplot()
    X_test = np.asarray(X_test)
    Y_true = np.asarray(Y_true)
    Y_pred = np.asarray(Y_pred)
    d = X_test.shape[1]
    residuals = Y_true - Y_pred

    if d == 1:
        fig, (ax_main, ax_config) = plt.subplots(
            1, 2, figsize=(16, 6), gridspec_kw={"width_ratios": [3, 1]}
        )
        order = np.argsort(X_test[:, 0])
        if X_train is not None:
            ax_main.scatter(X_train[:, 0], Y_train, c="lightblue", alpha=0.6,
                            s=20, label="Training Data")
        ax_main.scatter(X_test[:, 0], Y_true, c="red", alpha=0.7, s=30,
                        label="True Test Data")
        ax_main.plot(X_test[order, 0], Y_pred[order], "b-", linewidth=2,
                     label="GP Prediction")
        if Y_pred_var is not None:
            std = np.sqrt(np.asarray(Y_pred_var))
            xs, yp, sd = X_test[order, 0], Y_pred[order], std[order]
            ax_main.fill_between(xs, yp - 1.96 * sd, yp + 1.96 * sd,
                                 alpha=0.2, color="blue", label="95% Confidence")
            ax_main.fill_between(xs, yp - sd, yp + sd,
                                 alpha=0.3, color="blue", label="68% Confidence")
        ax_main.set_xlabel("X"); ax_main.set_ylabel("Y")
        ax_main.set_title(title); ax_main.legend(); ax_main.grid(True, alpha=0.3)
        _config_panel(ax_config, config, nlpd_info)
    elif d == 2:
        fig = plt.figure(figsize=(24, 6))
        panels = [("True Values", Y_true, "viridis", "Y"),
                  ("Predictions", Y_pred, "viridis", "Y"),
                  ("Residuals", residuals, "RdBu", "Residual")]
        for i, (name, vals, cmap, zl) in enumerate(panels):
            ax = fig.add_subplot(1, 4, i + 1, projection="3d")
            sc = ax.scatter(X_test[:, 0], X_test[:, 1], vals, c=vals,
                            cmap=cmap, s=20)
            ax.set_title(name)
            ax.set_xlabel("X1"); ax.set_ylabel("X2"); ax.set_zlabel(zl)
            plt.colorbar(sc, ax=ax, shrink=0.5)
        _config_panel(fig.add_subplot(144), config, nlpd_info)
        fig.suptitle(title)
    else:
        fig, axes = plt.subplots(1, 3, figsize=(18, 5))
        axes[0].scatter(Y_true, Y_pred, alpha=0.6, s=20)
        lims = [Y_true.min(), Y_true.max()]
        axes[0].plot(lims, lims, "r--", lw=2)
        axes[0].set_xlabel("True Values"); axes[0].set_ylabel("Predicted Values")
        axes[0].set_title("Prediction Correlation"); axes[0].grid(True, alpha=0.3)
        axes[1].scatter(Y_pred, residuals, alpha=0.6, s=20)
        axes[1].axhline(0.0, color="r", lw=1, ls="--")
        axes[1].set_xlabel("Predicted Values"); axes[1].set_ylabel("Residuals")
        axes[1].set_title("Residual Plot"); axes[1].grid(True, alpha=0.3)
        _config_panel(axes[2], config, nlpd_info)
        fig.suptitle(f"{title} ({d}D Input)")
    fig.tight_layout()
    return _save(fig, save_plot, output_dir, filename)


_SRTM_REGION_TITLES = {
    "maharashtra": "Maharashtra, India (N17E073)",
    "great_lakes": "Great Lakes Region (N43W080)",
    "oregon_coast": "Oregon Coast Range (N45W123)",
    "washington_coast": "Washington Coast (N47W124)",
}


def _dataset_labels(dataset_name: str, region: Optional[str], n: int):
    """Dataset-specific titles / axis labels / colormap
    (real_world_datasets.py:607-638).

    Parity quirk preserved: SRTM/SST loaders stack X as [lat, lon]
    (real_world_datasets.py:91, 406) yet the reference labels column 0
    "Longitude" in every panel — the mislabeling is reproduced verbatim so
    figures are comparable side by side."""
    name = dataset_name.lower()
    if "srtm" in name or "elevation" in name:
        title = "SRTM Elevation Data"
        if region:
            title += " - " + _SRTM_REGION_TITLES.get(
                region, region.replace("_", " ").title())
        return (title, f"{n:,} points",
                "Longitude (°)", "Latitude (°)", "Elevation (m)", "terrain")
    if "sst" in name or "temperature" in name:
        return ("Sea Surface Temperature", f"{n:,} points",
                "Longitude (°)", "Latitude (°)", "Temperature (°C)", "coolwarm")
    if "robot" in name or "push" in name:
        return ("Robot Pushing Dataset", f"{n:,} points",
                "Feature 1", "Feature 2", "Displacement", "viridis")
    return (f"{dataset_name.title()} Dataset", f"{n:,} points",
            "X1", "X2", "Y", "viridis")


def plot_real_world_dataset(X, Y, dataset_name="unknown", region=None,
                            save_plot=True, output_dir="plots") -> Optional[str]:
    """Real-world dataset visualization, panel-for-panel with the reference
    (real_world_datasets.py:586-790):

    * 2D — six panels: 3D scatter, 2D projection colored by value,
      value histogram with a stats box, value-vs-each-axis marginals, and a
      monospace dataset-summary panel (coverage, median/quartiles, NaN/Inf
      quality metrics, coefficient of variation);
    * 3D — four panels: 3D feature-space scatter + three pairwise
      projections.

    Saved at dpi=300 as ``{name}[_{region}]_{N}pts.png`` (3D:
    ``..._3D.png``); SRTM callers pass ``output_dir='srtm_plots'``.
    """
    plt = pyplot()
    X = np.asarray(X)
    Y = np.asarray(Y)
    d = X.shape[1]
    n = X.shape[0]
    title, subtitle, x_label, y_label, z_label, cmap = _dataset_labels(
        dataset_name, region, n)
    safe = dataset_name.replace(" ", "_").replace("/", "_")

    if d == 2:
        fig = plt.figure(figsize=(20, 12))

        ax_main = fig.add_subplot(231, projection="3d")
        sc = ax_main.scatter(X[:, 0], X[:, 1], Y, c=Y, cmap=cmap, s=15, alpha=0.7)
        ax_main.set_xlabel(x_label); ax_main.set_ylabel(y_label)
        ax_main.set_zlabel(z_label)
        ax_main.set_title(f"{title}\n{subtitle}", fontweight="bold")
        plt.colorbar(sc, ax=ax_main, shrink=0.6, label=z_label)

        ax_2d = fig.add_subplot(232)
        sc2 = ax_2d.scatter(X[:, 0], X[:, 1], c=Y, cmap=cmap, s=20, alpha=0.7)
        ax_2d.set_xlabel(x_label); ax_2d.set_ylabel(y_label)
        ax_2d.set_title("2D Projection (colored by value)", fontweight="bold")
        plt.colorbar(sc2, ax=ax_2d, label=z_label)
        ax_2d.grid(True, alpha=0.3)

        ax_hist = fig.add_subplot(233)
        ax_hist.hist(Y, bins=50, alpha=0.7, color="skyblue",
                     edgecolor="black", linewidth=0.5)
        ax_hist.set_xlabel(z_label); ax_hist.set_ylabel("Frequency")
        ax_hist.set_title("Value Distribution", fontweight="bold")
        ax_hist.grid(True, alpha=0.3)
        ax_hist.text(0.75, 0.95,
                     f"Mean: {Y.mean():.2f}\nStd: {Y.std():.2f}\n"
                     f"Min: {Y.min():.2f}\nMax: {Y.max():.2f}",
                     transform=ax_hist.transAxes, verticalalignment="top",
                     bbox=dict(boxstyle="round", facecolor="wheat", alpha=0.8))

        for pos, (col, clr, xl) in ((234, (0, "red", x_label)),
                                    (235, (1, "green", y_label))):
            ax = fig.add_subplot(pos)
            ax.scatter(X[:, col], Y, alpha=0.5, s=10, color=clr)
            ax.set_xlabel(xl); ax.set_ylabel(z_label)
            ax.set_title(f"{z_label} vs {xl}", fontweight="bold")
            ax.grid(True, alpha=0.3)

        ax_stats = fig.add_subplot(236)
        ax_stats.axis("off")
        ax_stats.set_title("Dataset Summary", fontweight="bold", fontsize=14)
        nan_n, inf_n = int(np.sum(np.isnan(Y))), int(np.sum(np.isinf(Y)))
        cov = (Y.std() / abs(Y.mean())) * 100 if Y.mean() != 0 else float("inf")
        summary = (
            f"Dataset: {title}\nSamples: {n:,}\n\nSpatial Coverage:\n"
            f"  {x_label}: [{X[:, 0].min():.4f}, {X[:, 0].max():.4f}]\n"
            f"  {y_label}: [{X[:, 1].min():.4f}, {X[:, 1].max():.4f}]\n\n"
            f"Value Statistics:\n"
            f"  {z_label}: [{Y.min():.2f}, {Y.max():.2f}]\n"
            f"  Mean: {Y.mean():.2f}\n  Median: {np.median(Y):.2f}\n"
            f"  Std Dev: {Y.std():.2f}\n"
            f"  25th Percentile: {np.percentile(Y, 25):.2f}\n"
            f"  75th Percentile: {np.percentile(Y, 75):.2f}\n\n"
            f"Quality Metrics:\n"
            f"  Missing Values: {nan_n} ({nan_n / n * 100:.1f}%)\n"
            f"  Infinite Values: {inf_n} ({inf_n / n * 100:.1f}%)\n"
            f"  Value Range: {Y.max() - Y.min():.2f}\n"
            f"  Coeff. of Variation: {cov:.1f}%"
        )
        ax_stats.text(0.05, 0.95, summary, transform=ax_stats.transAxes,
                      fontsize=10, verticalalignment="top",
                      fontfamily="monospace",
                      bbox=dict(boxstyle="round", facecolor="lightgray",
                                alpha=0.8))
        fig.tight_layout()
        fname = (f"{safe}_{region.replace(' ', '_')}_{n}pts.png" if region
                 else f"{safe}_{n}pts.png")
        return _save(fig, save_plot, output_dir, fname)

    if d == 3:
        fig = plt.figure(figsize=(18, 12))
        ax_main = fig.add_subplot(221, projection="3d")
        sc = ax_main.scatter(X[:, 0], X[:, 1], X[:, 2], c=Y, cmap=cmap,
                             s=15, alpha=0.7)
        ax_main.set_xlabel("Feature 1"); ax_main.set_ylabel("Feature 2")
        ax_main.set_zlabel("Feature 3")
        ax_main.set_title(f"{title} - 3D Feature Space\n{subtitle}",
                          fontweight="bold")
        plt.colorbar(sc, ax=ax_main, shrink=0.6, label=z_label)
        for i, ((a, b), ptitle) in enumerate([((0, 1), "Features 1 vs 2"),
                                              ((0, 2), "Features 1 vs 3"),
                                              ((1, 2), "Features 2 vs 3")]):
            ax = fig.add_subplot(2, 2, i + 2)
            scp = ax.scatter(X[:, a], X[:, b], c=Y, cmap=cmap, s=20, alpha=0.7)
            ax.set_xlabel(f"Feature {a + 1}"); ax.set_ylabel(f"Feature {b + 1}")
            ax.set_title(ptitle, fontweight="bold")
            if i == 0:
                plt.colorbar(scp, ax=ax, label=z_label)
            ax.grid(True, alpha=0.3)
        fig.tight_layout()
        return _save(fig, save_plot, output_dir, f"{safe}_{n}pts_3D.png")

    # >3D: pairwise marginals + stats (beyond the reference, which prints
    # "Plotting not implemented" here)
    fig, axes = plt.subplots(1, min(4, d) + 1, figsize=(4.5 * (min(4, d) + 1), 4))
    for i in range(min(4, d)):
        axes[i].scatter(X[:, i], Y, s=6, alpha=0.5)
        axes[i].set_title(f"{z_label} vs Feature {i + 1}")
    _config_panel(axes[-1], {"samples": n, "dims": d,
                             "Y mean": round(float(Y.mean()), 3),
                             "Y std": round(float(Y.std()), 3)})
    fig.suptitle(f"{title}\n{subtitle}")
    return _save(fig, save_plot, output_dir, f"{safe}_{n}pts_{d}D.png")


def plot_convergence(nll_history: List[Dict], cv_history: List[Dict],
                     error_history: Optional[List[float]] = None,
                     save_plot=True, output_dir="results") -> Optional[str]:
    """NLL / CV-NLPD / GT-error evolution (main.py:2786-3094 analytics)."""
    plt = pyplot()
    n_panels = 2 + (1 if error_history else 0)
    fig, axes = plt.subplots(1, n_panels, figsize=(5 * n_panels, 4))
    iters = [h["iteration"] for h in nll_history]
    axes[0].plot(iters, [h["total_nll"] for h in nll_history], "o-", ms=3)
    axes[0].set_xlabel("iteration"); axes[0].set_title("Total NLL")
    if cv_history:
        cvi = [h["iteration"] for h in cv_history]
        cvs = [h["consensus_cv_score"] for h in cv_history]
        axes[1].plot(cvi, cvs, "o-", ms=3, c="tab:green")
    axes[1].set_xlabel("iteration"); axes[1].set_title("CV-NLPD of consensus z")
    if error_history:
        axes[2].plot(iters[: len(error_history)], error_history, "o-", ms=3, c="tab:red")
        axes[2].set_xlabel("iteration")
        axes[2].set_title("Riemannian distance to ground truth")
    fig.tight_layout()
    return _save(fig, save_plot, output_dir, "convergence.png")
