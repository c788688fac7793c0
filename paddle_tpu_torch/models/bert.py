"""BERT: the configuration and presets, the encoder model and its
fine-tune and pretraining heads, as ``torch.nn.Module``s.

Counterpart of ``paddle_tpu/models/bert.py`` (BASELINE config 3, the
BERT-base fine-tune) with its attribute names, so a JAX ``state_dict``
loads one to one.  The encoder is :class:`..nn.transformer.
TransformerEncoder` (post-LN, exact-erf GELU), so attention takes flash
(the CUDA kernels on the card) only without a pad mask and without
dropout, and the LayerNorms are the jnp chain, as in the JAX package.

Parameters are fp32 (cast a model with ``.to(torch.bfloat16)``), drawn
from ``generator`` (seed 0 on ``device`` when None), which also draws the
dropout masks: embeddings normal(0, ``initializer_range``), ``Linear``
weights Xavier-uniform, biases zero, norm gains one.  ``device=None``
means CUDA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import make_generator, resolve_device
from ..nn import functional as F
from ..nn.layer import Dropout, Embedding, LayerNorm, Linear, Tanh
from ..nn.transformer import TransformerEncoder, TransformerEncoderLayer

__all__ = ["BertConfig", "BertEmbeddings", "BertPooler", "BertModel",
           "BertForSequenceClassification", "BertForPretraining",
           "bert_tiny", "bert_base", "bert_large"]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


def bert_tiny(**kw) -> BertConfig:
    kw.setdefault("vocab_size", 256)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("intermediate_size", 128)
    kw.setdefault("max_position_embeddings", 64)
    return BertConfig(**kw)


def bert_base(**kw) -> BertConfig:
    return BertConfig(**kw)


def bert_large(**kw) -> BertConfig:
    kw.setdefault("hidden_size", 1024)
    kw.setdefault("num_layers", 24)
    kw.setdefault("num_heads", 16)
    kw.setdefault("intermediate_size", 4096)
    return BertConfig(**kw)


def _model_kw(generator, device):
    """The device resolved and the generator (seed 0 there when None)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else make_generator(0, dev)
    return dict(generator=gen, device=dev)


class BertEmbeddings(torch.nn.Module):
    """Word, position (int64 ``arange(s)``) and token-type embeddings
    (token types default to zeros), summed, then LayerNorm and dropout."""

    def __init__(self, cfg: BertConfig, *, generator=None, device=None):
        super().__init__()
        kw = dict(std=cfg.initializer_range, generator=generator,
                  device=device)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, **kw)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size, **kw)
        self.layer_norm = LayerNorm(cfg.hidden_size,
                                    epsilon=cfg.layer_norm_eps,
                                    device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob, generator=generator)

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1], dtype=torch.int64,
                           device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = x + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(x))


class BertPooler(torch.nn.Module):
    def __init__(self, cfg: BertConfig, *, generator=None, device=None):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size,
                            generator=generator, device=device)
        self.activation = Tanh()

    def forward(self, hidden):
        return self.activation(self.dense(hidden[:, 0]))


class BertModel(torch.nn.Module):
    """The embeddings, the post-LN encoder stack and the pooler.
    ``forward(input_ids, token_type_ids=None, attention_mask=None)``
    gives ``(sequence output [b, s, H], pooled [b, H])``.  A 2-D pad mask
    ``[b, s]`` (1 keep, 0 pad) becomes the additive fp32 bias ``(m - 1) *
    1e9`` of shape ``[b, 1, 1, s]``; any other mask is passed on as it
    is."""

    def __init__(self, cfg: BertConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = _model_kw(generator, device)
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, **kw)
        enc_layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation=cfg.hidden_act,
            attn_dropout=cfg.attention_probs_dropout_prob,
            act_dropout=0.0, layer_norm_eps=cfg.layer_norm_eps, **kw)
        self.encoder = TransformerEncoder(enc_layer, cfg.num_layers)
        self.pooler = BertPooler(cfg, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        if attention_mask is not None and attention_mask.ndim == 2:
            m = attention_mask.float()
            attention_mask = ((m - 1.0) * 1e9).reshape(m.shape[0], 1, 1,
                                                       m.shape[1])
        x = self.embeddings(input_ids, token_type_ids)
        x = self.encoder(x, src_mask=attention_mask)
        return x, self.pooler(x)


class BertForSequenceClassification(torch.nn.Module):
    """The fine-tune head (BASELINE config 3): dropout on the pooled
    output, then ``classifier``; with ``labels`` the mean cross-entropy,
    else the logits ``[b, num_classes]``."""

    def __init__(self, cfg: BertConfig, num_classes: int = 2, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = _model_kw(generator, device)
        self.bert = BertModel(cfg, **kw)
        self.dropout = Dropout(cfg.hidden_dropout_prob,
                               generator=kw["generator"])
        self.classifier = Linear(cfg.hidden_size, num_classes, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, labels)
        return logits


class BertForPretraining(torch.nn.Module):
    """MLM and NSP heads; the MLM decoder is tied to the word embeddings
    (``h @ word_embeddings.weightᵀ``).  With ``mlm_labels`` the MLM loss
    over labels other than -100 (plus the NSP loss when ``nsp_labels``
    are given), else ``(mlm_logits [b, s, V], nsp_logits [b, 2])``."""

    def __init__(self, cfg: BertConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = _model_kw(generator, device)
        self.cfg = cfg
        self.bert = BertModel(cfg, **kw)
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.transform_ln = LayerNorm(cfg.hidden_size,
                                      epsilon=cfg.layer_norm_eps,
                                      device=kw["device"])
        self.nsp_head = Linear(cfg.hidden_size, 2, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                mlm_labels=None, nsp_labels=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.transform_ln(F.gelu(self.transform(seq)))
        mlm_logits = h @ self.bert.embeddings.word_embeddings.weight.t()
        nsp_logits = self.nsp_head(pooled)
        if mlm_labels is not None:
            loss = F.cross_entropy(mlm_logits.reshape(-1, self.cfg.vocab_size),
                                   mlm_labels.reshape(-1), ignore_index=-100)
            if nsp_labels is not None:
                loss = loss + F.cross_entropy(nsp_logits, nsp_labels)
            return loss
        return mlm_logits, nsp_logits
