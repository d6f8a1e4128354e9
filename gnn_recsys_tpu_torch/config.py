"""Typed configuration: paths, fixed parameters, searched hyperparameters.

Host copy of ``gnn_recsys_tpu/config.py`` (framework-neutral; the port keeps
its own so that it never imports the JAX package).  Field names, defaults
and the JSON round-trip are identical, so a run directory written by either
package configures the other.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Tuple

# Item-id granularity (reference main.py:63-65).
SPECIFIC = "specific_id"
GENERAL = "general_id"

# Reference embed-size name -> (out_dim, hidden_dim) map (main.py:86-89).
EMBED_DIMS = {
    "small": (32, 64),
    "medium": (128, 256),
    "large": (256, 512),
}

# Reference popularity-importance -> (use, weight, days) map (main.py:92-97).
POPULARITY_IMPORTANCE = {
    "no": (False, 0.0, 0),
    "small": (True, 0.05, 50),
    "medium": (True, 0.1, 100),
    "large": (True, 0.2, 365),
}


@dataclasses.dataclass
class ColumnConfig:
    """Column names of the interaction/feature files (the reference
    hard-codes the Decathlon names in its graph-building module)."""

    ctm_id: str = "CUSTOMER IDENTIFIER"
    specific_item_id: str = "SPECIFIC ITEM IDENTIFIER"
    general_item_id: str = "GENERAL ITEM IDENTIFIER"
    spt_id: str = "sport_id"
    sportsgroup_id: str = "sportsgroup_id"
    sports_id: str = "sports_id"
    hit_date: str = "hit_date"
    hit_timestamp: str = "hit_timestamp"
    buy: str = "buy"

    def item_id(self, item_id_type: str) -> str:
        return (
            self.specific_item_id if item_id_type == SPECIFIC
            else self.general_item_id
        )


@dataclasses.dataclass
class DataPaths:
    """File locations (reference ``DataPaths``, src/utils_data.py:10-21)."""

    train_path: str = ""
    test_path: str = ""
    item_sport_path: str = ""
    user_sport_path: str = ""
    sport_sportg_path: str = ""
    item_feat_path: str = ""
    user_feat_path: str = ""
    sport_feat_path: str = ""
    sport_onehot_path: str = ""
    result_filepath: str = "outputs/result_log.txt"


@dataclasses.dataclass
class FixedParams:
    """Non-searched configuration (reference ``FixedParameters``,
    src/utils_data.py:23-116; identical defaults)."""

    ctm_id_type: str = "CUSTOMER IDENTIFIER"
    item_id_type: str = SPECIFIC
    spt_id_type: str = "sport_id"
    days_of_purchases: int = 365
    days_of_clicks: int = 30
    lifespan_of_items: int = 180
    discern_clicks: bool = True
    duplicates: str = "keep_all"  # keep_all | keep_last | count_occurrence
    include_sport: bool = True
    train_on_clicks: bool = True
    remove: float = 0.0
    remove_false_negative: bool = True
    remove_train_eids: bool = False
    remove_on_inference: float = 0.7
    # In-loop inference evaluation after each trial (reference
    # utils_data.py:98, main.py:418-436): 0 = off, 1 = re-evaluate on a
    # rebuilt graph with ``remove_on_inference`` user sampling, 2 = also
    # re-evaluate with 710-day windows ("all users").
    run_inference: int = 1
    explore: bool = True
    num_choices: int = 10
    k: int = 10
    valid_size: float = 0.05
    subtrain_size: float = 0.05
    edge_batch_size: int = 2048
    node_batch_size: int = 128
    neighbor_sampler: str = "full"  # full | partial
    num_epochs: int = 100
    start_epoch: int = 0
    patience: int = 3
    pred: str = "cos"
    report_model_coverage: bool = False
    # TPU-specific (no reference counterpart): rematerialize sampled-tree
    # levels on backward — trade ~1 extra forward for activation memory on
    # deep (n_layers 4-5) / wide-fanout models.
    remat_levels: bool = False
    # TPU-specific: cap on the padded CSC neighbor-row width when
    # building the graph (None = exact, rows as wide as the hottest hub's
    # in-degree).  A cap keeps each destination's most RECENT edges
    # (coo_to_padded_csc; the reference's recency bias,
    # src/sampling.py:72-82) and bounds both HBM for the neighbor tables
    # and the full-fanout frontier width on power-law data.
    max_fanout: "int | None" = None
    # TPU-specific: bucket trial shapes so jit/compile-cache keys collapse
    # across hyperparameter points (an HP search recompiles every distinct
    # shape otherwise): per-etype train/valid eid counts truncate DOWN to
    # a multiple of 256 (dropping the OLDEST edges — the reference's
    # recency-sampling bias, src/sampling.py:72-82) and neg_sample_size
    # rounds UP to a multiple of 128 (more negatives than asked, never
    # fewer).  Off by default: exact reference shape semantics.
    bucket_shapes: bool = False
    # Embedding inference for eval/serving: 'full_graph' = one jit'd
    # layer-wise pass over the device-resident graph (exactly equal to the
    # full-fanout sampled tree, O(L*E) total); 'node_batches' = the
    # reference's node-loader shape for graphs whose layer-wise
    # activations exceed HBM.
    inference_mode: str = "full_graph"

    @property
    def train_etypes(self) -> Tuple[Tuple[str, str, str], ...]:
        ets = [("user", "buys", "item")]
        if self.discern_clicks and self.train_on_clicks:
            ets.append(("user", "clicks", "item"))
        return tuple(ets)

    @property
    def reverse_etype(self) -> Dict[Tuple[str, str, str], Tuple[str, str, str]]:
        out = {("user", "buys", "item"): ("item", "bought-by", "user")}
        if self.discern_clicks:
            out[("user", "clicks", "item")] = ("item", "clicked-by", "user")
        return out


@dataclasses.dataclass
class HyperParams:
    """The searched hyperparameters (reference ``SearchableHyperparameters``,
    main.py:485-511; defaults = the reference's x0 at main.py:508-511)."""

    aggregator_hetero: str = "mean"
    aggregator_type: str = "mean_nn"
    clicks_sample: float = 0.3
    delta: float = 0.266
    dropout: float = 0.01
    embedding_layer: bool = False
    embed_dim: str = "medium"  # -> (out_dim, hidden_dim) via EMBED_DIMS
    lr: float = 0.00017985194246308484
    n_layers: int = 3
    neg_sample_size: int = 2500
    norm: bool = True
    popularity_importance: str = "no"
    purchases_sample: float = 0.5
    use_recency: bool = True
    # Training objective (extension; the reference trains the hinge
    # only, src/model.py:473-533): 'max_margin' or 'sampled_softmax'
    # (InfoNCE over the negative pool; tau from ``softmax_tau``).  On
    # the hard benchmark the softmax at tau=0.2 sustains raw recall
    # +14% over the hinge (docs/results/quality_r5_summary.json).
    loss: str = "max_margin"
    softmax_tau: float = 0.2

    @property
    def out_dim(self) -> int:
        return EMBED_DIMS[self.embed_dim][0]

    @property
    def hidden_dim(self) -> int:
        return EMBED_DIMS[self.embed_dim][1]

    @property
    def use_popularity(self) -> bool:
        return POPULARITY_IMPORTANCE[self.popularity_importance][0]

    @property
    def weight_popularity(self) -> float:
        return POPULARITY_IMPORTANCE[self.popularity_importance][1]

    @property
    def days_popularity(self) -> int:
        return POPULARITY_IMPORTANCE[self.popularity_importance][2]

    @property
    def serve_with_popularity_boost(self) -> bool:
        """Whether SERVING applies the reference popularity boost
        (``softmax(scores) + w * popularity``, src/metrics.py:69-72).

        Boost transfer is objective-dependent (measured, r5): it adds
        ~+4% recall to hinge-trained latents but is NEGATIVE for
        softmax-trained latents (their cosine geometry already encodes
        popularity) — so softmax-trained models serve boost-free by
        default regardless of ``popularity_importance``.  Feature-side
        popularity (``use_popularity``) is unaffected.
        """
        return self.use_popularity and self.loss != "sampled_softmax"

    def resolved_aggregator_type(self, duplicates: str) -> str:
        """count_occurrence edges imply the *_edge aggregator variant
        (reference main.py:99-100)."""
        if duplicates == "count_occurrence" and not self.aggregator_type.endswith("_edge"):
            return self.aggregator_type + "_edge"
        return self.aggregator_type


def save_config(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(obj), f, indent=2)


def load_config(cls, path: str):
    with open(path) as f:
        return cls(**json.load(f))
