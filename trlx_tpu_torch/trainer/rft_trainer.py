"""RFT trainer (counterpart of ``trlx_tpu/trainer/rft_trainer.py``): every
``n_improve_steps`` epochs it samples ``n_generations_per_prompt``
generations of every prompt and scores them with the reward function; each
epoch it keeps the generations at or above a per-prompt percentile
threshold that rises from ``start_percentile`` to ``end_percentile``,
deduplicates them, and trains on the survivors with the SFT step (full
cross-entropy over prompt and output, as the reference's ``labels =
input_ids``). Generation prefill and the learner run the flash kernels on
the card, as in :mod:`trlx_tpu_torch.trainer.sft_trainer`.
"""

from collections import defaultdict

import numpy as np

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.methods.rft import RFTConfig
from trlx_tpu_torch.pipeline.offline_pipeline import DialogMessage, DialogStore, tokenize_dialogue
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer
from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


@register_trainer
class RFTTrainer(SFTTrainer):
    def __init__(self, config: TRLConfig, **kwargs):
        if not isinstance(config.method, RFTConfig):
            raise ValueError("RFTTrainer requires method=RFTConfig")
        super().__init__(config, **kwargs)
        self.method: RFTConfig = config.method
        self.generate_experience_kwargs = None

    def add_prompt_pipeline(self, pipeline):
        self.prompt_loader = pipeline.create_loader(self.config.train.batch_size)

    def prepare_learning(self):
        super().prepare_learning()
        self.epoch_count = 0
        self.generations_per_prompt = defaultdict(list)
        self.store = None
        self.make_experience()

    def post_epoch_callback(self, epoch: int):
        self.make_experience()
        self.epoch_count += 1

    def create_train_dataloader(self):
        if self.store is None or len(self.store.history) == 0:
            return iter(())
        return self.store.create_loader(
            self.config.train.batch_size, shuffle=True, seed=self.config.train.seed + self.epoch_count
        )

    def make_experience(self):
        """Generate and score on an improve epoch, then filter every
        prompt's generations so far by this epoch's percentile into a fresh
        :class:`DialogStore`; logs ``rft/scores_mean``,
        ``rft/len_samples_selected`` and ``rft/percentile``."""
        method = self.method
        if self.epoch_count % method.n_improve_steps == 0:
            generations = []
            for batch in self.prompt_loader:
                prompts = batch["input_ids"]
                for _ in range(method.n_generations_per_prompt):
                    samples, resp_mask, pad_len = self.generate(prompts, eval_mode=True)
                    _, str_prompts, str_outputs, _ = self.decode(
                        prompts, samples, pad_len, append_eos=True, response_masks=resp_mask
                    )
                    generations.extend({"prompt": p, "output": o} for p, o in zip(str_prompts, str_outputs))
            scores = self.reward_fn(
                samples=[x["prompt"] + x["output"] for x in generations],
                prompts=[x["prompt"] for x in generations],
                outputs=[x["output"] for x in generations],
                tokenizer=self.tokenizer,
            )
            for g, s in zip(generations, scores):
                self.generations_per_prompt[g["prompt"]].append({"output": g["output"], "score": float(s)})

        per_prompt_scores = [
            [x["score"] for x in self.generations_per_prompt[p]] for p in self.generations_per_prompt
        ]
        percentile_delta = (method.end_percentile - method.start_percentile) / method.n_improve_steps
        percentile = method.start_percentile + percentile_delta * (self.epoch_count % method.n_improve_steps)
        thresholds = np.array([np.quantile(np.array(s), percentile) for s in per_prompt_scores])
        # quantized-reward corner case: exclude min values, never exclude max values
        thresholds = np.clip(thresholds, thresholds.min() + 1e-3, thresholds.max() - 1e-3)

        samples_selected = []
        for prompt, threshold in zip(self.generations_per_prompt, thresholds):
            for x in self.generations_per_prompt[prompt]:
                if x["score"] >= threshold:
                    samples_selected.append((prompt, x["output"]))
        samples_selected = sorted(set(samples_selected))

        stats = {
            "rft/scores_mean": float(np.mean(np.hstack(per_prompt_scores))),
            "rft/len_samples_selected": len(samples_selected),
            "rft/percentile": percentile,
        }
        self.tracker.log(stats, self.iter_count)
        logger.info(f"RFT improve step: {stats}")

        if samples_selected:
            dialogs = [
                tokenize_dialogue([p, o], self.tokenizer, self.config.train.seq_length)
                for p, o in samples_selected
            ]
            # full-CE supervision (the reference's labels = input_ids)
            dialogs = [[DialogMessage(True, m.tokens) for m in d] for d in dialogs]
            self.store = DialogStore(dialogs, self.tokenizer)
