"""Public ``train()`` entry (counterpart of ``trlx_tpu/trlx.py``): builds
the trainer and its pipelines and runs ``learn()``.

Dispatch rows, as in the JAX package (``config`` overrides the default
when given):

==========================  =========================  ========================
 given                       mode                       default config
==========================  =========================  ========================
 ``reward_fn``               online RL (PPO/GRPO/RFT)   ``default_ppo_config``
 ``environment``             environment RL (GRPO)      ``default_grpo_config``
 ``samples`` + ``rewards``   offline RL (ILQL)          ``default_ilql_config``
 ``samples``                 supervised (SFT)           ``default_sft_config``
==========================  =========================  ========================

``reward_fn`` with an ``RFTConfig`` (``train.trainer="RFTTrainer"``) runs
rejection fine-tuning, with a ``GRPOConfig`` (``train.trainer=
"GRPOTrainer"``) GRPO. ``environment`` is an
:class:`~trlx_tpu_torch.online.environment.Environment` scored through its
stateless ``evaluate``: it is adapted into a reward_fn and flows through
the ``reward_fn`` row.

``device=None`` runs on the CUDA device and raises when there is none;
``device="cpu"`` runs the plain CPU path.

Across ranks, launch one process per rank with ``TRLX_NUM_PROCESSES``,
``TRLX_COORDINATOR`` (``host:port``) and ``TRLX_PROCESS_ID`` set; ``train``
joins the process group first (:func:`~trlx_tpu_torch.parallel.mesh.
initialize_distributed`) and ``config.mesh`` lays the ranks out.
"""

from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import (
    default_grpo_config,
    default_ilql_config,
    default_ppo_config,
    default_sft_config,
)
from trlx_tpu_torch.online.environment import environment_reward_fn
from trlx_tpu_torch.parallel.mesh import initialize_distributed
from trlx_tpu_torch.utils import logging, set_seed
from trlx_tpu_torch.utils.loading import get_pipeline, get_trainer

logger = logging.get_logger(__name__)


def train(
    model_path: Optional[str] = None,
    reward_fn: Optional[Callable] = None,
    dataset: Optional[Iterable[Tuple[str, float]]] = None,
    samples: Optional[List[str]] = None,
    rewards: Optional[List[float]] = None,
    prompts: Optional[List[Union[str, Dict]]] = None,
    eval_prompts: Optional[List[Union[str, Dict]]] = None,
    metric_fn: Optional[Callable] = None,
    config: Optional[TRLConfig] = None,
    stop_sequences: Optional[List[str]] = None,
    environment=None,
    device=None,
):
    """Fit with PPO (or GRPO, RFT) from ``reward_fn`` and ``prompts``, with
    GRPO from ``environment`` and ``prompts``, with ILQL from ``samples``
    and ``rewards``, or with SFT from ``samples`` (strings or (prompt,
    output, ...) dialogues): the JAX package's surface plus ``device``.
    Returns the trainer."""
    # the process group before anything that picks a device
    initialize_distributed(device=device)
    if reward_fn is not None and environment is not None:
        raise ValueError(
            "`reward_fn` and `environment` are mutually exclusive: an environment IS the reward source"
        )
    if dataset is not None:
        logger.warning("the `dataset` argument is being depreciated, split it into `samples` and `rewards` instead")
        samples, rewards = dataset
    if reward_fn is None and environment is None and samples is None:
        raise ValueError(
            "One of `samples` (SFT / +`rewards` for ILQL), `reward_fn` (PPO / GRPO / RFT) or `environment` "
            "(GRPO) should be given for training"
        )
    if config is None:
        logger.warning(
            "Passing the `config` argument implicitly is depreciated, use or adapt one of the default configs instead"
        )
        if reward_fn:
            config = default_ppo_config()
        elif environment is not None:
            config = default_grpo_config()
        elif rewards:
            config = default_ilql_config()
        else:
            config = default_sft_config()
    if environment is not None:
        reward_fn = environment_reward_fn(environment)
    if model_path:
        config.model.model_path = model_path

    set_seed(config.train.seed)
    trainer = get_trainer(config.train.trainer)(
        config=config,
        reward_fn=reward_fn,
        metric_fn=metric_fn,
        stop_sequences=stop_sequences,
        device=device,
        **config.train.trainer_kwargs,
    )

    batch_size = config.train.batch_size
    max_prompt_length = config.train.seq_length - config.method.gen_kwargs.get("max_new_tokens", 0)
    if reward_fn:
        prompts = prompts or [trainer.tokenizer.bos_token] * batch_size
        if eval_prompts is None:
            eval_prompts = prompts[:batch_size]
        pipeline = get_pipeline(config.train.pipeline)(prompts, max_prompt_length, trainer.tokenizer)
        trainer.add_prompt_pipeline(pipeline)
    elif rewards is not None:
        if len(samples) != len(rewards):
            raise ValueError(f"Number of samples {len(samples)} should match the number of rewards {len(rewards)}")
        if eval_prompts is None:
            eval_prompts = [trainer.tokenizer.bos_token] * batch_size
        trainer.make_experience(samples, rewards, config.train.seq_length)
    else:
        if eval_prompts is None:
            eval_prompts = [trainer.tokenizer.bos_token] * batch_size
        trainer.make_experience(samples, config.train.seq_length)
    eval_pipeline = get_pipeline(config.train.pipeline)(eval_prompts, max_prompt_length, trainer.tokenizer)
    trainer.add_eval_pipeline(eval_pipeline)

    trainer.learn()
    return trainer
